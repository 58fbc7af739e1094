"""Attack-quality report for vision data (counterpart of the vision branch of
``breaching_tpu/analysis/analysis.py`` ``report``).

Reports MSE, PSNR, SSIM, the worst image's MSE, label accuracy and the
feature-space MSE through the payload model. With ``order_batch`` a batch of
several reconstructions is first put in the order that matches the true images by
pixel MSE (``metrics.compute_batch_order``) and the order is reported; every image
metric, the feature-space MSE too, is taken in that order. LPIPS is reported as
NaN, as the JAX package reports it when no LPIPS weights are on disk (the repo
holds none). Not ported yet: LPIPS, CW-SSIM, registered PSNR and IIP.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import functional_call

from . import metrics as M

log = logging.getLogger(__name__)


def report(reconstructed_user_data, true_user_data, server_payload, model,
           order_batch=True, compute_full_iip=False, cfg_case=None, setup=None, loss_fn=None):
    metadata = server_payload[0]["metadata"]
    if metadata.modality != "vision":
        raise NotImplementedError(f"{metadata.modality} metrics are not ported yet.")
    if compute_full_iip:
        raise NotImplementedError("IIP scores are not ported yet.")
    rec = torch.as_tensor(reconstructed_user_data["data"], dtype=torch.float32)
    ref = torch.as_tensor(true_user_data["data"], dtype=torch.float32, device=rec.device)
    dm = torch.as_tensor(metadata.mean, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    ds = torch.as_tensor(metadata.std, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    rec_den = torch.clamp(rec * ds + dm, 0, 1)
    ref_den = torch.clamp(ref * ds + dm, 0, 1)

    order = None
    if order_batch and rec.shape[0] == ref.shape[0] and rec.shape[0] > 1:
        # the label accuracy counts a multiset: the order of the labels cannot change it
        order = M.compute_batch_order(rec_den, ref_den)
        index = torch.as_tensor(order, device=rec.device)
        rec, rec_den = rec[index], rec_den[index]

    mse, psnr = M.mse_psnr(rec_den, ref_den, factor=1.0, clip=True)
    test_metrics = dict(
        mse=float(mse),
        psnr=float(psnr),
        ssim=float(M.ssim(rec_den, ref_den)),
        max_mse=float(torch.amax(torch.mean((rec_den - ref_den) ** 2, dim=(1, 2, 3)))),
        lpips=float("nan"),
        order=order,
    )
    test_metrics["label_acc"] = _label_accuracy(reconstructed_user_data, true_user_data)
    test_metrics["feat_mse"] = _feature_space_mse(rec, ref, server_payload, model)
    test_metrics["parameters"] = int(sum(p.numel() for p in server_payload[0]["parameters"].values()))
    log.info(f"METRICS: | MSE: {test_metrics['mse']:2.4f} | PSNR: {test_metrics['psnr']:4.2f} | "
             f"FMSE: {test_metrics['feat_mse']:2.4e} | LPIPS: {test_metrics['lpips']:4.2f} | "
             f"SSIM: {test_metrics['ssim']:2.4f} | "
             f"Label Acc: {test_metrics['label_acc']:2.2%}")
    return test_metrics


def _label_accuracy(rec_data, true_data):
    """Multiset label overlap via bincount (reference: analysis.py:282-312)."""
    rec_labels, true_labels = rec_data.get("labels"), true_data.get("labels")
    if rec_labels is None or true_labels is None:
        return float("nan")
    rec_labels = torch.as_tensor(rec_labels).cpu().numpy().reshape(-1)
    true_labels = torch.as_tensor(true_labels).cpu().numpy().reshape(-1)
    num_classes = int(max(rec_labels.max(initial=0), true_labels.max(initial=0))) + 1
    overlap = np.minimum(np.bincount(rec_labels, minlength=num_classes),
                         np.bincount(true_labels, minlength=num_classes)).sum()
    return float(overlap / max(len(true_labels), 1))


def _feature_space_mse(rec, ref, server_payload, model):
    """MSE between the pre-head features of reconstruction and truth through the
    payload model (reference: analysis.py:57-76)."""
    payload = server_payload[0]
    buffers = payload["buffers"] if payload["buffers"] is not None else dict(model.named_buffers())
    state = {**payload["parameters"], **buffers}
    with torch.no_grad():
        rec_feats = functional_call(model, state, (rec,), dict(features=True))
        ref_feats = functional_call(model, state, (ref,), dict(features=True))
    return float(torch.mean((rec_feats - ref_feats) ** 2))
