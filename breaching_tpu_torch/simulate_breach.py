"""Run a single FL exchange and attack it (counterpart of ``simulate_breach.py``).

    python3 -m breaching_tpu_torch.simulate_breach case=2_single_imagenet attack=invertinggradients

Overrides take the JAX package's ``key=value`` form. From the command line it runs
on the CUDA device; ``main_process(cfg, device="cpu")`` runs the same on the CPU.
It logs the attack's progress and a ``METRICS:`` line with the reconstruction's
quality (``analysis.report``), appends the run's row to
``<base_dir>/tables/table_breach_<case>.csv``, writes the metrics to
``<base_dir>/metrics_<name>.yaml`` and, with ``save_reconstruction=True``, the
reconstruction to ``<base_dir>/reconstructions/``; a dry run writes no table row, as in
the JAX package. With
``case.server.feature_estimation_users`` N > 0 the fishing server first polls the users
of the next N ``user_idx`` slots to estimate the target class's feature distribution,
then cuts the target user.

Over several ranks (``attack.impl.sharding``, ``attacks/sharding.py``), every rank runs
the exchange and the attack from the same seed and only rank 0 writes the records:

    torchrun --nproc-per-node=N -m breaching_tpu_torch.simulate_breach case=2_single_imagenet \
        attack=invertinggradients attack.restarts.num_trials=4 attack.impl.sharding=restarts

``torchrun`` is ``python3 -m torch.distributed.run``; the ranks take NCCL where every rank of
a host has a card of its own, else gloo (several ranks sharing one card, or the CPU). The
command line's run ends by logging the kernels' launches (``Kernel launches: {...}``).
"""

from __future__ import annotations

import datetime
import json
import logging
import sys
import time

import breaching_tpu_torch as breaching
from breaching_tpu_torch import ops

log = logging.getLogger(__name__)


def main_process(cfg, device="cuda", outputs=None):
    """Build the case and the attacker, run the exchange and the attack, report, and
    write the run's records (reference simulate_breach.py:22-58). Returns the metrics. ``outputs``, where given,
    receives what the JAX entry point saves beside them: the user, the server, the
    attack's stats, the reconstruction and the user's true data."""
    total_time = time.time()
    n_extra = int(cfg.case.server.get("feature_estimation_users", 0) or 0)
    if n_extra and cfg.case.server.name not in ("class_malicious_parameters", "malicious_fishing"):
        raise NotImplementedError(f"Feature-estimation users need the class-parameter (fishing) server, not "
                                  f"{cfg.case.server.name}.")
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    log.info(f"{user}\n{server}\n{attacker}")

    if cfg.case.user.get("user_idx") is None:
        cfg.case.user.user_idx = 0
    if n_extra:  # the additional users own the next user_idx slots of the partition
        base_idx = int(cfg.case.user.user_idx)
        additional_users = []
        for idx in range(base_idx + 1, base_idx + 1 + n_extra):
            cfg.case.user.user_idx = idx
            additional_users.append(breaching.cases.construct_user(model, server.loss, cfg.case, setup))
        cfg.case.user.user_idx = base_idx
        shared_user_data, payloads, true_user_data = server.run_protocol(user, additional_users=additional_users)
    else:
        shared_user_data, payloads, true_user_data = server.run_protocol(user)
    reconstructed_user_data, stats = attacker.reconstruct(payloads, shared_user_data, server.secrets,
                                                          dryrun=cfg.dryrun)
    if outputs is not None:
        outputs.update(user=user, server=server, stats=stats, reconstruction=reconstructed_user_data,
                       true=true_user_data)
    metrics = breaching.analysis.report(reconstructed_user_data, true_user_data, payloads, server.model,
                                        order_batch=True, compute_full_iip=False, cfg_case=cfg.case, setup=setup)
    breaching.utils.save_summary(cfg, metrics, stats, time.time() - total_time)
    breaching.utils.dump_metrics(cfg, metrics)
    if cfg.save_reconstruction:
        breaching.utils.save_reconstruction(reconstructed_user_data, payloads, true_user_data, cfg)
    return metrics


def main_launcher(argv=None):
    cfg = breaching.get_config(sys.argv[1:] if argv is None else argv)
    log.info(f"------------- Launching breaching-tpu (PyTorch) run {cfg.name} -------------")
    launch_time = time.time()
    metrics = main_process(cfg)
    log.info(f"Finished computations with total time: "
             f"{datetime.timedelta(seconds=time.time() - launch_time)}")
    log.info(f"Kernel launches: {json.dumps(ops.launch_counts())}")
    return metrics


if __name__ == "__main__":
    main_launcher()
