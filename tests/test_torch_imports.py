"""The PyTorch port and chip_smoke.py import nothing of JAX, its libraries, PyYAML, PIL
or the JAX package: the machine with the card has none of them."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, os, pkgutil, sys

    BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "yaml", "PIL", "breaching_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                raise ImportError(f"refused import of {name}")
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, os.getcwd())

    import breaching_tpu_torch
    names = ["breaching_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(breaching_tpu_torch.__path__, "breaching_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # main() is not run on import
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in BANNED)
    assert not loaded, loaded
    print(len(names))
""")


def test_port_imports_no_jax_yaml_or_reference_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module of the package was imported: the package, its subpackages and modules
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25
