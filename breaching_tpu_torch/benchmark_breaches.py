"""Attack many users and average their metrics (counterpart of ``benchmark_breaches.py``;
reference benchmark_breaches.py:22-119).

    python3 -m breaching_tpu_torch.benchmark_breaches case=2_single_imagenet attack=invertinggradients \\
        attack.objective.type=fused-cosine-similarity num_trials=16 fleet=8

Users 0, 1, ... of one server are attacked in waves of ``fleet`` through
``reconstruct_fleet`` (one attack step advances every user of the wave; an attack
without a fleet mode, and ``fleet=1``, goes one user at a time). Users with fewer
examples than ``num_data_points`` are skipped. Each user's reconstruction is reported
with every IIP score; its row, with the wave's seconds per user and its own
``Trial_<t>_Val`` losses sliced out of the wave's stats, is appended to
``<base_dir>/tables/table_benchmark_<case>.csv``, and with ``save_reconstruction=True``
its images go to ``<base_dir>/reconstructions/<name>_user<idx>_rec_<i>.png``. The mean
of the users' numbers goes to ``outputs/tables/BENCHMARK_breach_<case>_<attack>.csv``
and is returned. A user whose report fails is logged and skipped, a wave whose attack
fails too, and Ctrl-C averages the users done so far, as in the JAX package. From the
command line it runs on the CUDA device; ``main_process(cfg, device="cpu")`` on the
CPU.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time

import breaching_tpu_torch as breaching

log = logging.getLogger(__name__)


def main_process(cfg, device="cuda", outputs=None):
    """Run the benchmark (reference benchmark_breaches.py:22-119) and return the averaged
    metrics. ``outputs``, where given, receives ``model``, the server's model the reports
    read, ``reports``: for each user reported, (user_idx, metrics, that user's stats,
    reconstruction, true data, payloads), and ``failures``: (user indices, exception) for
    every user or wave that failed."""
    local_time = time.time()
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    model, loss_fn = breaching.cases.construct_model(cfg.case.model, cfg.case.data,
                                                     pretrained=cfg.case.server.pretrained,
                                                     generator=setup["generator"])
    model.to(device=setup["device"], dtype=breaching.utils.model_dtype(setup))
    server = breaching.cases.construct_server(model, loss_fn, cfg.case, setup)
    model = server.vet_model(model)
    attacker = breaching.attacks.prepare_attack(model, loss_fn, cfg.attack, setup)
    if outputs is not None:
        outputs.update(model=server.model, reports=[], failures=[])

    if cfg.case.user.user_idx is not None:
        print("The argument user_idx is disregarded during the benchmark. Starting at user 0.")
    cfg.case.user.user_idx = -1

    fleet = max(int(cfg.get("fleet", 1) or 1), 1)
    if fleet > 1 and not getattr(attacker, "supports_fleet", False):
        log.info(f"Attack {cfg.attack.attack_type} has no fleet mode; running sequentially.")
        fleet = 1

    overall_metrics = []
    run = 0
    while run < cfg.num_trials:
        wave, exhausted = [], False
        while len(wave) < min(fleet, cfg.num_trials - run):
            cfg.case.user.user_idx += 1
            try:
                user = breaching.cases.construct_user(model, loss_fn, cfg.case, setup)
            except ValueError:
                log.info("Cannot find other valid users. Finishing benchmark.")
                exhausted = True
                break
            if len(user.dataloader.dataset) < user.num_data_points:
                log.info(f"Skipping user {user.user_idx} (too little data or shape mismatch).")
                continue
            wave.append(user)
        if not wave:
            break
        run += len(wave)
        local_run_time = time.time()
        log.info(f"Now evaluating users {[u.user_idx for u in wave]} (trials {run - len(wave) + 1}..{run}).")
        try:
            exchanges = [server.run_protocol(user) for user in wave]
            if len(wave) > 1:
                reconstructions, stats = attacker.reconstruct_fleet(
                    [e[1] for e in exchanges], [e[0] for e in exchanges], server.secrets, dryrun=cfg.dryrun)
            else:
                shared_user_data, payloads, _ = exchanges[0]
                reconstruction, stats = attacker.reconstruct(payloads, shared_user_data, server.secrets,
                                                             dryrun=cfg.dryrun)
                reconstructions = [reconstruction]
            wave_time = (time.time() - local_run_time) / len(wave)
            trials_per = max(len([k for k in stats if k.startswith("Trial_")]) // max(len(wave), 1), 1)
            for w, (user, (_, payloads, true_user_data), reconstruction) in enumerate(
                    zip(wave, exchanges, reconstructions)):
                try:
                    metrics = breaching.analysis.report(reconstruction, true_user_data, payloads, server.model,
                                                        order_batch=True, compute_full_iip=True,
                                                        cfg_case=cfg.case, setup=setup)
                    if len(wave) > 1:  # this user's trials out of the wave's stats
                        user_stats = {k: v for k, v in stats.items() if not k.startswith("Trial_")}
                        for t in range(trials_per):
                            key = f"Trial_{w * trials_per + t}_Val"
                            if key in stats:
                                user_stats[f"Trial_{t}_Val"] = stats[key]
                    else:
                        user_stats = stats
                    row = dict(spent_time=wave_time, user_idx=user.user_idx, **{
                        k: v for k, v in metrics.items() if not isinstance(v, (list, dict, type(None)))})
                    overall_metrics.append(row)
                    breaching.utils.save_summary(cfg, metrics, user_stats, wave_time, table_name="benchmark")
                    if cfg.save_reconstruction:
                        breaching.utils.save_reconstruction(reconstruction, payloads, true_user_data, cfg,
                                                            user_idx=user.user_idx)
                    if outputs is not None:
                        outputs["reports"].append((user.user_idx, metrics, user_stats, reconstruction,
                                                   true_user_data, payloads))
                except Exception as e:  # noqa: BLE001 (the rest of the wave is still reported)
                    log.info(f"Report for user {user.user_idx} failed with {type(e).__name__}: {e}. Continuing.")
                    if outputs is not None:
                        outputs["failures"].append(([user.user_idx], e))
            if cfg.dryrun:
                break
        except KeyboardInterrupt:
            log.info(f"Benchmark interrupted manually during users {[u.user_idx for u in wave]}; averaging "
                     f"{len(overall_metrics)} completed trials.")
            break
        except Exception as e:  # noqa: BLE001 (the failed users keep their slots, as in the JAX package)
            log.info(f"Trial on users {[u.user_idx for u in wave]} failed with {type(e).__name__}: {e}. "
                     f"Continuing.")
            if outputs is not None:
                outputs["failures"].append(([u.user_idx for u in wave], e))
        if exhausted:
            break

    average_metrics = breaching.utils.avg_n_dicts(overall_metrics)
    log.info(f"Average benchmark metrics over {len(overall_metrics)} users: {average_metrics}")
    breaching.utils.save_to_table("outputs/tables", f"BENCHMARK_breach_{cfg.case.name}_{cfg.attack.type}",
                                  cfg.dryrun, **average_metrics)
    log.info(f"Total benchmark time: {datetime.timedelta(seconds=time.time() - local_time)}")
    return average_metrics


def main_launcher(argv=None):
    cfg = breaching.get_config(sys.argv[1:] if argv is None else argv)
    log.info(f"-------- Launching breaching-tpu (PyTorch) benchmark {cfg.name} --------")
    return main_process(cfg)


if __name__ == "__main__":
    main_launcher()
