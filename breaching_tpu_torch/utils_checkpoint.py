"""Attack-state checkpoints (counterpart of ``breaching_tpu/utils_checkpoint.py``).

An attack run's state (the candidate tree, the optimizer's moments and step count,
the best iterates and values, and the state of every generator that draws inside
the loop) is a set of named arrays. ``save_attack_state`` writes them with the
iteration reached to one numpy ``.npz`` file, written beside the target and moved
over it, so that a preemption during the write leaves the previous checkpoint;
``load_attack_state`` reads them back where every name and shape fits the run's own
state, and otherwise warns and returns None, so that the run starts fresh.
"""

from __future__ import annotations

import logging
import os
import tempfile

import numpy as np

log = logging.getLogger(__name__)


def save_attack_state(path: str, arrays: dict, iteration: int) -> None:
    """Write ``arrays`` (name -> numpy array) and ``iteration`` to ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, partial = tempfile.mkstemp(suffix=".npz", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, iteration=np.asarray(iteration), **{f"state/{k}": v for k, v in arrays.items()})
        os.replace(partial, path)
    except BaseException:
        os.unlink(partial)
        raise
    log.info(f"Checkpointed attack state at iteration {iteration} to {path}.")


def load_attack_state(path: str, template: dict):
    """The arrays and iteration saved at ``path``, as (arrays, iteration), if the file
    exists and holds exactly the names of ``template`` (name -> array) at their shapes;
    else None (with a warning if the file exists)."""
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as blob:
        saved = {k[len("state/"):]: blob[k] for k in blob.files if k.startswith("state/")}
        iteration = int(blob["iteration"])
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
