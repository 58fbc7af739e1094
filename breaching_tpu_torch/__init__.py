"""breaching-tpu's PyTorch/CUDA port: gradient-inversion attacks against federated
learning on an NVIDIA GPU, beside the JAX package ``breaching_tpu`` it is checked
against.

Same entry points as the JAX package:
    get_config / get_attack_config / get_case_config — config composition,
    utils.system_startup — the ``setup`` dict (device, dtype, generator),
    cases.construct_case — FL simulation assembly,
    attacks.prepare_attack — attack assembly,
    analysis.report — reconstruction-quality metrics.
They run on the CUDA device unless the caller passes ``device="cpu"`` to
``system_startup``. The package imports torch, numpy and the standard library only.
"""

from . import utils
from .config.loader import ConfigNode, compose

__version__ = "0.1.0"


def get_config(overrides=None):
    """Compose the full framework configuration (case + attack + globals)."""
    return compose("cfg", overrides)


def get_attack_config(attack="invertinggradients", overrides=None):
    """Compose only an attack configuration."""
    return compose("cfg", [f"attack={attack}", *(overrides or [])]).attack


def get_case_config(case="1_single_image_small", overrides=None):
    """Compose only a case configuration."""
    return compose("cfg", [f"case={case}", *(overrides or [])]).case


from . import analysis, attacks, cases  # noqa: E402

__all__ = [
    "ConfigNode",
    "analysis",
    "attacks",
    "cases",
    "compose",
    "get_attack_config",
    "get_case_config",
    "get_config",
    "utils",
]
