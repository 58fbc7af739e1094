"""Attack-quality report for vision data (counterpart of ``breaching_tpu/analysis/analysis.py``).

``report`` returns, in the JAX package's order: MSE, PSNR, SSIM, CW-SSIM on the DTCWT
(``cw_ssim``) and on a Gabor bank (``gabor_cw_ssim``), registered PSNR (``rpsnr``),
the worst image's MSE, LPIPS (NaN unless LPIPS weights are on disk:
``lpips.find_lpips_weights``), the batch order, with ``compute_full_iip`` the image
identifiability precision in pixel space, LPIPS features (with weights) and the
attacked model's own features (``IIP-pixel``, ``IIP-lpips``, ``IIP-self``), then the
label accuracy, the feature-space MSE through the payload model and the parameter
count.

With ``order_batch`` a batch of several reconstructions is put in the order that
matches the true images (by LPIPS features where a scorer exists, else by pixels) and
every image metric is taken in that order. As in the JAX package, the caller's dict
takes the new order (``data`` and ``order`` are written into it) only when it holds
no labels; with labels the order stays in a copy, so the feature-space MSE, which
reads the caller's dict, and a reconstruction saved afterwards keep the original
order.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import functional_call

from . import metrics as M
from .dtcwt import dtcwt_cw_ssim
from .lpips import load_lpips

log = logging.getLogger(__name__)


def report(reconstructed_user_data, true_user_data, server_payload, model,
           order_batch=True, compute_full_iip=False, cfg_case=None, setup=None, loss_fn=None):
    metadata = server_payload[0]["metadata"]
    if metadata.modality != "vision":
        raise NotImplementedError(f"{metadata.modality} metrics are not ported yet.")
    test_metrics = _run_vision_metrics(reconstructed_user_data, true_user_data, server_payload, model,
                                       order_batch, compute_full_iip, cfg_case)
    test_metrics["label_acc"] = _label_accuracy(reconstructed_user_data, true_user_data)
    test_metrics["feat_mse"] = _feature_space_mse(reconstructed_user_data, true_user_data, server_payload, model)
    test_metrics["parameters"] = int(sum(p.numel() for p in server_payload[0]["parameters"].values()))
    log.info(f"METRICS: | MSE: {test_metrics['mse']:2.4f} | PSNR: {test_metrics['psnr']:4.2f} | "
             f"FMSE: {test_metrics['feat_mse']:2.4e} | LPIPS: {test_metrics['lpips']:4.2f} | "
             f"R-PSNR: {test_metrics['rpsnr']:4.2f} | SSIM: {test_metrics['ssim']:2.4f} | "
             f"Label Acc: {test_metrics['label_acc']:2.2%}")
    return test_metrics


def _run_vision_metrics(rec_data, true_data, server_payload, model, order_batch, compute_full_iip, cfg_case):
    metadata = server_payload[0]["metadata"]
    rec = torch.as_tensor(rec_data["data"], dtype=torch.float32)
    ref = torch.as_tensor(true_data["data"], dtype=torch.float32, device=rec.device)
    dm = torch.as_tensor(metadata.mean, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    ds = torch.as_tensor(metadata.std, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    rec_den = torch.clamp(rec * ds + dm, 0, 1)
    ref_den = torch.clamp(ref * ds + dm, 0, 1)

    lpips_scorer = load_lpips(cfg_case)
    if lpips_scorer is not None:
        lpips_scorer = lpips_scorer.to(rec.device)

    if order_batch and rec.shape[0] == ref.shape[0] and rec.shape[0] > 1:
        order = M.compute_batch_order(rec_den, ref_den, lpips_scorer=lpips_scorer)
        index = torch.as_tensor(order, device=rec.device)
        rec, rec_den = rec[index], rec_den[index]
        labels = rec_data.get("labels")
        if labels is not None and torch.as_tensor(labels).dim() > 0:
            rec_data = dict(rec_data, labels=torch.as_tensor(labels)[torch.as_tensor(order)])
        rec_data["data"] = rec
        rec_data["order"] = order

    with torch.no_grad():
        mse, psnr = M.mse_psnr(rec_den, ref_den, factor=1.0, clip=True)
        out = dict(
            mse=float(mse),
            psnr=float(psnr),
            ssim=float(M.ssim(rec_den, ref_den)),
            cw_ssim=float(dtcwt_cw_ssim(rec_den, ref_den)),
            gabor_cw_ssim=float(M.cw_ssim(rec_den, ref_den)),
            rpsnr=float(M.registered_psnr(rec_den, ref_den)),
            max_mse=float(torch.amax(torch.mean((rec_den - ref_den) ** 2, dim=(1, 2, 3)))),
            lpips=float(torch.mean(lpips_scorer(rec_den, ref_den))) if lpips_scorer is not None else float("nan"),
            order=rec_data.get("order"),
        )
        if compute_full_iip and cfg_case is not None:
            out.update(_compute_iip(rec_den, ref_den, cfg_case, model=model, lpips_scorer=lpips_scorer))
    return out


def _iip_pool(cfg_case, pool_cap, device):
    """The denormalized images of the full dataset's first ``pool_cap`` examples (all
    of them for 0); the loader stops at the batch that reaches the cap."""
    from ..cases.data import construct_dataloader

    loader = construct_dataloader(cfg_case.data, cfg_case.impl, user_idx=0, return_full_dataset=True)
    dm = np.asarray(cfg_case.data.mean, np.float32).reshape(-1, 1, 1)
    ds = np.asarray(cfg_case.data.std, np.float32).reshape(-1, 1, 1)
    pool = []
    for batch in loader:
        pool.append(batch["inputs"])
        if pool_cap and sum(p.shape[0] for p in pool) >= pool_cap:
            break
    pool = np.concatenate(pool)
    if pool_cap:
        pool = pool[:pool_cap]
    return torch.as_tensor(np.clip(pool * ds + dm, 0, 1), dtype=torch.float32, device=device)


def _compute_iip(rec_den, ref_den, cfg_case, model=None, lpips_scorer=None):
    """IIP in pixel space, in LPIPS feature space (with a scorer) and in the attacked
    model's own pre-head features (reference metrics.py:245-295). The decoy pool is
    the full dataset cut at ``cfg_case.impl.iip_pool_cap`` (256 by default; 0 takes
    all of it)."""
    pool_cap = int(getattr(cfg_case.impl, "iip_pool_cap", 256) or 0) if hasattr(cfg_case, "impl") else 256
    pool_den = _iip_pool(cfg_case, pool_cap, rec_den.device)
    out = {"IIP-pixel": float(M.image_identifiability_precision(rec_den, ref_den, pool_den))}
    if lpips_scorer is not None:
        out["IIP-lpips"] = float(M.image_identifiability_precision(
            lpips_scorer.features(rec_den), lpips_scorer.features(ref_den), lpips_scorer.features(pool_den)))
    if model is not None:
        dm = torch.as_tensor(cfg_case.data.mean, dtype=torch.float32, device=rec_den.device).reshape(1, -1, 1, 1)
        ds = torch.as_tensor(cfg_case.data.std, dtype=torch.float32, device=rec_den.device).reshape(1, -1, 1, 1)

        def feats(x):
            return model((x - dm) / ds, features=True).reshape(x.shape[0], -1)

        try:
            out["IIP-self"] = float(M.image_identifiability_precision(feats(rec_den), feats(ref_den),
                                                                      feats(pool_den)))
        except (TypeError, AttributeError):  # a model without pre-head features
            pass
    return out


def _label_accuracy(rec_data, true_data):
    """Multiset label overlap via bincount (reference: analysis.py:282-312); labels
    below 0 (an ignore index) are left out."""
    rec_labels, true_labels = rec_data.get("labels"), true_data.get("labels")
    if rec_labels is None or true_labels is None:
        return float("nan")
    rec_labels = torch.as_tensor(rec_labels).cpu().numpy().reshape(-1)
    true_labels = torch.as_tensor(true_labels).cpu().numpy().reshape(-1)
    rec_labels = rec_labels[rec_labels >= 0]
    true_labels = true_labels[true_labels >= 0]
    num_classes = int(max(rec_labels.max(initial=0), true_labels.max(initial=0))) + 1
    overlap = np.minimum(np.bincount(rec_labels, minlength=num_classes),
                         np.bincount(true_labels, minlength=num_classes)).sum()
    return float(overlap / max(len(true_labels), 1))


def _feature_space_mse(rec_data, true_data, server_payload, model):
    """MSE between the pre-head features of the caller's reconstruction (in the order
    its dict holds) and the truth through the payload model (reference: analysis.py:57-76)."""
    payload = server_payload[0]
    buffers = payload["buffers"] if payload["buffers"] is not None else dict(model.named_buffers())
    state = {**payload["parameters"], **buffers}
    rec = torch.as_tensor(rec_data["data"], dtype=torch.float32)
    ref = torch.as_tensor(true_data["data"], dtype=torch.float32, device=rec.device)
    with torch.no_grad():
        rec_feats = functional_call(model, state, (rec,), dict(features=True))
        ref_feats = functional_call(model, state, (ref,), dict(features=True))
    return float(torch.mean((rec_feats - ref_feats) ** 2))
