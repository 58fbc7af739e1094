"""Run a single FL exchange and attack it (counterpart of ``simulate_breach.py``).

    python3 -m breaching_tpu_torch.simulate_breach case=2_single_imagenet attack=invertinggradients

Overrides take the JAX package's ``key=value`` form. From the command line it runs
on the CUDA device; ``main_process(cfg, device="cpu")`` runs the same on the CPU.
It logs the attack's progress and a ``METRICS:`` line with the reconstruction's
quality (``analysis.report``). Not ported: the summary table and the saved
reconstruction of the JAX entry point, and feature-estimation users.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time

import breaching_tpu_torch as breaching

log = logging.getLogger(__name__)


def main_process(cfg, device="cuda"):
    """Build the case and the attacker, run the exchange and the attack, and report
    (reference simulate_breach.py:22-58). Returns the metrics."""
    if int(cfg.case.server.get("feature_estimation_users", 0) or 0):
        raise NotImplementedError("Feature-estimation users are not ported yet.")
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    log.info(f"{user}\n{server}\n{attacker}")

    shared_user_data, payloads, true_user_data = server.run_protocol(user)
    reconstructed_user_data, stats = attacker.reconstruct(payloads, shared_user_data, server.secrets,
                                                          dryrun=cfg.dryrun)
    return breaching.analysis.report(reconstructed_user_data, true_user_data, payloads, server.model,
                                     order_batch=True, compute_full_iip=False, cfg_case=cfg.case,
                                     setup=setup)


def main_launcher(argv=None):
    cfg = breaching.get_config(sys.argv[1:] if argv is None else argv)
    log.info(f"------------- Launching breaching-tpu (PyTorch) run {cfg.name} -------------")
    launch_time = time.time()
    metrics = main_process(cfg)
    log.info(f"Finished computations with total time: "
             f"{datetime.timedelta(seconds=time.time() - launch_time)}")
    return metrics


if __name__ == "__main__":
    main_launcher()
