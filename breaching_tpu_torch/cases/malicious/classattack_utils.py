"""Utilities of the class and feature fishing attacks (counterpart of
``breaching_tpu/cases/malicious/classattack_utils.py``): the feature behind a class's
head gradients (the weight-over-bias trick), the Kolmogorov-Smirnov choice of a
feature (scipy's ``kstest``), the estimate of its statistics across users, and
per-example gradients.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch
from scipy import stats
from torch.func import functional_call

from ..models.model_preparation import head_grads


def wrap_indices(indices):
    if isinstance(indices, numbers.Number):
        return [indices]
    return list(indices)


def check_with_tolerance(value, values, threshold=1e-3):
    return any(abs(value - v) < threshold for v in values)


def reconstruct_feature(shared_data, cls_to_obtain, model):
    """The feature vector of class ``cls_to_obtain`` from the head's gradients: its weight
    row over its bias entry, zeros where that entry is within 1e-12 of 0 (reference:
    classattack_utils.py:53-66). ``model`` names the head."""
    grads = shared_data["gradients"] if "gradients" in shared_data else shared_data
    w_grad, b_grad = head_grads(grads, model)
    bias = b_grad[cls_to_obtain]
    if bool(bias.abs() > 1e-12):
        return w_grad[cls_to_obtain] / bias
    return torch.zeros_like(w_grad[cls_to_obtain])


def cal_single_gradients(model, loss_fn, true_user_data):
    """Each example's gradient, its entries joined in ``named_parameters`` order, and its
    loss, with BatchNorm in eval mode (reference loops the examples,
    classattack_utils.py:69-89): ((examples, parameters), (examples,))."""
    params = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    data = torch.as_tensor(true_user_data["data"])
    labels = torch.as_tensor(true_user_data["labels"]).to(data.device)
    flats, losses = [], []
    for x, y in zip(data, labels):
        loss = loss_fn(functional_call(model, {**params, **buffers}, (x[None],), dict(train=False)), y[None])
        grads = torch.autograd.grad(loss, tuple(params.values()))
        flats.append(torch.cat([g.reshape(-1) for g in grads]))
        losses.append(loss.detach())
    return torch.stack(flats), torch.stack(losses)


def order_gradients(recovered_single_gradients, gt_single_gradients):
    """Match recovered single gradients (dicts by parameter name) to the true ones (rows
    of ``cal_single_gradients``) by cosine similarity and an assignment (reference:
    classattack_utils.py:30-49)."""
    from scipy.optimize import linear_sum_assignment

    rec = np.stack([np.concatenate([g.detach().cpu().numpy().reshape(-1) for g in grad.values()])
                    for grad in recovered_single_gradients])
    gt = torch.as_tensor(gt_single_gradients).detach().cpu().numpy()
    rec_n = rec / np.maximum(np.linalg.norm(rec, axis=1, keepdims=True), 1e-10)
    gt_n = gt / np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-10)
    similarity = gt_n @ rec_n.T
    try:
        _, assignment = linear_sum_assignment(similarity, maximize=True)
    except ValueError:
        assignment = list(range(len(rec)))
    return [recovered_single_gradients[i] for i in assignment]


def estimate_gt_stats(est_features, sample_sizes, indx=0):
    """Mean and std of a feature across users, the std corrected by sqrt(n) (reference:
    classattack_utils.py:126-136)."""
    feature = np.asarray(est_features[indx])
    aggregated = [f * (s ** 0.5) for f, s in zip(feature, sample_sizes)]
    return float(np.mean(feature)), float(np.std(aggregated))


def find_best_feat(est_features, sample_sizes, method="kstest"):
    """The feature whose distribution across users is most Gaussian (reference:
    classattack_utils.py:138-162)."""
    est_features = np.asarray(est_features)
    if "kstest" in method:
        statistics = []
        for series in est_features:
            std = np.std(series)
            normed = (series - np.mean(series)) / (std if std > 0 else 1.0)
            statistics.append(stats.kstest(normed, "norm")[0])
        return int(np.argmin(statistics))
    if "most-spread" in method or "most-high-mean" in method:
        mus, sigmas = [], []
        for i in range(len(est_features)):
            mu, sigma = estimate_gt_stats(est_features, sample_sizes, indx=i)
            mus.append(mu)
            sigmas.append(sigma)
        return int(np.argmax(sigmas) if "most-spread" in method else np.argmax(mus))
    raise ValueError(f"Method {method} not implemented.")
