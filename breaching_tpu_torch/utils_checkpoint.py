"""Attack-state checkpoints (counterpart of ``breaching_tpu/utils_checkpoint.py``).

An attack run's state (the candidate tree, the optimizer's moments and step count,
the best iterates and values, and the state of every generator that draws inside
the loop) is a set of named arrays. ``save_attack_state`` writes them with the
iteration reached to one numpy ``.npz`` file, written beside the target and moved
over it, so that a preemption during the write leaves the previous checkpoint;
``load_attack_state`` reads them back where every name and shape fits the run's own
state, and otherwise warns and returns None, so that the run starts fresh.

Trials that run one after the other share one file, each in a ``section`` of its own
(``trial<t>/``, with its own iteration): a save rewrites its section and keeps the
others, so that the file holds every trial's state, as the JAX package's carry holds
all trials at once. A file from a run without sections does not fit one with them, and
the reverse.
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

log = logging.getLogger(__name__)


def _prefix(section):
    return "" if section is None else f"{section}/"


def save_attack_state(path: str, arrays: dict, iteration: int, section: str | None = None) -> None:
    """Write ``arrays`` (name -> numpy array) and ``iteration`` to ``path``, into
    ``section`` where given, keeping the file's other sections."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    entries = {}
    if section is not None and os.path.exists(path):
        with np.load(path) as blob:  # the other sections stay
            entries = {k: blob[k] for k in blob.files
                       if not (k == "iteration" or k.startswith("state/") or k.startswith(f"{section}/"))}
    prefix = _prefix(section)
    entries.update({f"{prefix}iteration": np.asarray(iteration), **{f"{prefix}state/{k}": v for k, v in arrays.items()}})
    fd, partial = tempfile.mkstemp(suffix=".npz", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **entries)
        os.replace(partial, path)
    except BaseException:
        os.unlink(partial)
        raise
    log.info(f"Checkpointed attack state at iteration {iteration} to {path}.")


def load_attack_state(path: str, template: dict, section: str | None = None):
    """The arrays and iteration saved at ``path`` (in ``section`` where given), as
    (arrays, iteration), if the file exists and holds exactly the names of ``template``
    (name -> array) at their shapes; else None (with a warning if the file exists)."""
    if not path or not os.path.exists(path):
        return None
    prefix = _prefix(section)
    with np.load(path) as blob:
        saved = {k[len(prefix + "state/"):]: blob[k] for k in blob.files if k.startswith(prefix + "state/")}
        if f"{prefix}iteration" not in blob.files:
            log.warning(f"Checkpoint {path} holds no {'state' if section is None else section}; ignoring checkpoint.")
            return None
        iteration = int(blob[f"{prefix}iteration"])
    if saved.keys() != template.keys():
        log.warning(f"Checkpoint {path} holds {sorted(saved)}, the run {sorted(template)}; ignoring checkpoint.")
        return None
    for name, expected in template.items():
        if saved[name].shape != expected.shape:
            log.warning(f"Checkpoint entry {name} has shape {saved[name].shape}, the run expects "
                        f"{expected.shape}; ignoring checkpoint.")
            return None
    log.info(f"Restored attack state at iteration {iteration} from {path}.")
    return saved, iteration
