"""Malicious servers (counterparts of ``breaching_tpu/cases/malicious/servers.py``):
``MaliciousModelServer`` ("Robbing the Fed", "Curious Abandon Honesty"),
``MaliciousTransformerServer`` ("Decepticons") and ``MaliciousClassParameterServer``
("Fishing for User Data").

``MaliciousModelServer`` puts an imprint block in front of the model (``ImprintedModel``,
the victim's parameters then named ``victim.*``), with ``position`` inside a ResNet
before that stage, or on text after a transformer's embedding (``imprint_block.*``), and
records the block's parameter names in its secrets for the readout. With
``handle_preceding_layers: VAE`` it also trains a decoder back to the images
(``aux_training.py``) and puts its ``decode`` into the secrets: on the top placement an
encoder and decoder of the images (``aux_arch``, the VAE by default, 200 steps), inside a
ResNet a ``FeatureDecoder`` of the unmodified prefix's feature map (800 steps), each on the
server's external data where it has them.
``MaliciousTransformerServer`` rewires a transformer's parameters
(``transformer_rewiring.py``). ``MaliciousClassParameterServer`` edits the classification
head between queries, in place on the server's model, and restores the original
parameters after the protocol. Each acts on the model the user also holds, as the JAX
package's server and user share one model.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..models.layers import BatchNorm
from ..models.model_preparation import head_grads, head_keys, head_name
from ..servers import HonestServer
from . import imprint as imprint_blocks
from .classattack_utils import (check_with_tolerance, estimate_gt_stats, find_best_feat, reconstruct_feature,
                                wrap_indices)

log = logging.getLogger(__name__)


class ImprintedModel(nn.Module):
    """The imprint block runs on the input, the victim model on its output."""

    def __init__(self, block: nn.Module, victim: nn.Module):
        super().__init__()
        self.block = block
        self.victim = victim
        self.name = getattr(victim, "name", type(victim).__name__)
        self.head_name = f"victim.{head_name(victim)}"

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        return self.victim(self.block(x, train=train), train=train, features=features, capture=capture)


class MaliciousModelServer(HonestServer):
    """Inserts an imprint block in front of the model (reference: servers.py:171-381)."""

    THREAT = "Malicious (analyst)"
    CANDIDATE_BLOCKS = dict(
        ImprintBlock=imprint_blocks.ImprintBlock,
        SparseImprintBlock=imprint_blocks.SparseImprintBlock,
        OneShotBlock=imprint_blocks.OneShotBlock,
        OneShotBlockSparse=imprint_blocks.OneShotBlockSparse,
        CuriousAbandonHonesty=imprint_blocks.CuriousAbandonHonesty,
    )

    def vet_model(self, model):
        """Place the malicious block and record its secrets."""
        cfg_mod = self.cfg_server.model_modification
        block_cls = self.CANDIDATE_BLOCKS[cfg_mod.type]
        kwargs = dict(num_bins=int(cfg_mod.num_bins), connection=cfg_mod.get("connection", "linear"))
        for field in block_cls.FIELDS:
            if cfg_mod.get(field) is not None:
                kwargs[field] = cfg_mod[field]
        reference = next(model.parameters())
        if self.cfg_data.modality == "text":
            return self._vet_text_model(model, block_cls, kwargs, reference)
        c, h, w = self.cfg_data.shape
        if cfg_mod.get("position") is not None:
            return self._vet_resnet_deep(model, block_cls, kwargs, cfg_mod, reference)

        block = block_cls((h, w, c), **kwargs).to(device=reference.device, dtype=reference.dtype)
        new_model = ImprintedModel(block, model)
        gain = float(self.cfg_server.get("model_gain", 1.0) or 1.0)
        if gain != 1.0:
            with torch.no_grad():
                for param in model.parameters():
                    param.mul_(gain)
        self.secrets["ImprintBlock"] = dict(weight_name="block.linear0.weight", bias_name="block.linear0.bias",
                                            shape=(h, w, c), structure=block.structure)
        if cfg_mod.get("handle_preceding_layers") == "VAE":
            from .aux_training import train_encoder_decoder

            decode, _ = train_encoder_decoder((h, w, c), dataloader=self.external_dataloader, steps=200,
                                              arch=str(cfg_mod.get("aux_arch") or "VAE"), device=reference.device)
            self.secrets["ImprintBlock"]["decoder"] = decode
        self.model = new_model
        for _ in range(int(self.cfg_server.get("normalize_rounds", 0) or 0)):
            self._normalize_throughput(new_model, gain=gain)
        return new_model

    def _vet_resnet_deep(self, model, block_cls, block_kwargs, cfg_mod, reference):
        """The block before stage ``position`` of a ResNet (reference
        _place_malicious_block, servers.py:240-278); ``handle_preceding_layers=identity``
        makes the prefix an identity map (``_linearize_prefix``), so that the readout
        recovers the input's first channels directly, and ``VAE`` keeps it and trains a
        decoder of its feature map."""
        from ..models.resnets import ResNet

        if not isinstance(model, ResNet):
            raise ValueError(f"Deep imprint placement is implemented for the ResNet family "
                             f"(got {getattr(model, 'name', type(model).__name__)}).")
        position = int(cfg_mod.position)
        handle = cfg_mod.get("handle_preceding_layers") or "identity"
        c, h, w = self.cfg_data.shape
        fh, fw = (h // 4, w // 4) if model.stem == "ImageNet" else (h, w)
        feats = model.width
        for s in range(position):  # the feature map entering stage `position`
            stride = model.strides[s]
            fh, fw = -(-fh // stride), -(-fw // stride)
            feats = model.width * (2 ** s) * (4 if model.block_type == "bottleneck" else 1)
        data_shape = (fh, fw, feats)
        block = block_cls(data_shape, **block_kwargs).to(device=reference.device, dtype=reference.dtype)
        model.place_imprint(block, position, linear_prefix=handle == "identity")
        if handle == "identity":
            _linearize_prefix(model, position)
        self.secrets["ImprintBlock"] = dict(weight_name="imprint_block.linear0.weight",
                                            bias_name="imprint_block.linear0.bias", shape=data_shape,
                                            structure=block.structure)
        if handle == "VAE":
            # a decoder of the actual prefix: the imprint block's input on the unmodified
            # victim, D(prefix(x)) ~ x, each image's features in the readout's (H, W, C) order
            from .aux_training import train_feature_decoder

            decode, _ = train_feature_decoder(lambda x: model.features_before(x, position).permute(0, 2, 3, 1),
                                              (h, w, c), data_shape, dataloader=self.external_dataloader,
                                              device=reference.device)
            self.secrets["ImprintBlock"]["decoder"] = decode
        self.model = model
        return model

    def _vet_text_model(self, model, block_cls, block_kwargs, reference):
        """The block after a transformer's embedding, on its (seq, D) sequences (the JAX
        package's ``_vet_text_model``); the victim keeps its parameters."""
        from ..models.language_models import TransformerModel

        if not isinstance(model, TransformerModel):
            raise ValueError(f"Text imprint placement is implemented for the flax TransformerModel family "
                             f"(got {getattr(model, 'name', type(model).__name__)}).")
        data_shape = (int(self.cfg_data.shape[0]), int(model.ninp))
        block = block_cls(data_shape, **block_kwargs).to(device=reference.device, dtype=reference.dtype)
        model.imprint_block = block
        self.secrets["ImprintBlock"] = dict(weight_name="imprint_block.linear0.weight",
                                            bias_name="imprint_block.linear0.bias", shape=data_shape,
                                            structure=block.structure)
        self.model = model
        return model

    def _probe_batch(self):
        """The batch ``_normalize_throughput`` measures on: 8 images of the external data
        where the server has them, else standard normal images of the data's shape
        (``data.batch_size`` of them, 8 without one), drawn on the CPU from seed 7."""
        if self.external_dataloader is not None:
            return torch.as_tensor(next(iter(self.external_dataloader))["inputs"][:8])
        c, h, w = self.cfg_data.shape
        count = int(self.cfg_data.get("batch_size") or 8)
        return torch.randn((count, c, h, w), generator=torch.Generator().manual_seed(7))

    def _normalize_throughput(self, model, gain=1.0, probe=None):
        """Reset each layer's output to zero mean and standard deviation ``gain`` on a probe
        batch (reference: servers.py:314-366), in execution order: each BatchNorm's scale
        and bias, and each biased convolution's kernel and bias, are divided by its
        output's std / gain (+1e-8) and shifted by its mean, the output re-measured after
        every change above it. Bias-less downsample convolutions are zeroed and downsample
        norms left alone; dense layers (the head, the imprint block) stay."""
        reference = next(model.parameters())
        x = (self._probe_batch() if probe is None else probe).to(device=reference.device, dtype=reference.dtype)
        named = {module: name for name, module in model.named_modules()}
        order, hooks = [], [module.register_forward_hook(lambda mod, inputs, output: order.append(named[mod]))
                            for module in named if isinstance(module, (nn.Conv2d, BatchNorm))]
        try:
            with torch.no_grad():
                model(x, train=False)
        finally:
            for hook in hooks:
                hook.remove()
        for name in order:
            module = model.get_submodule(name)
            is_downsample = "downsample" in name
            if isinstance(module, nn.Conv2d) and module.bias is None:
                if is_downsample:
                    with torch.no_grad():
                        module.weight.zero_()
                    log.info(f"Reset weight in downsample {name} to zero.")
                continue
            if isinstance(module, BatchNorm) and is_downsample:
                continue
            out = _module_output(model, module, x)
            std, mu = float(out.std(unbiased=False)), float(out.mean())
            log.info(f"Layer {name}: mean {mu:.4f}, std {std:.4f}.")
            correction = std / gain + 1e-8
            with torch.no_grad():
                module.weight.div_(correction)
                module.bias.sub_(mu / correction)


def _module_output(model: nn.Module, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s output in one forward of ``model`` on ``x``, in eval mode."""
    captured = []
    hook = module.register_forward_hook(lambda mod, inputs, output: captured.append(output))
    try:
        with torch.no_grad():
            model(x, train=False)
    finally:
        hook.remove()
    return captured[0]


def _linearize_prefix(model, position: int) -> None:
    """Make the ResNet's layers before stage ``position`` an identity map (reference
    _linearize_up_to_imprint, servers.py:280-312): the stem convolution and every
    downsample convolution a Dirac kernel replicated over the input channels, the other
    convolutions of those stages zero, their norms identities (scale 1, bias 0, mean 0,
    variance 1); the residuals carry the signal."""

    def dirac_replicated(weight):
        cout, cin, kh, kw = weight.shape
        weight.zero_()
        weight[torch.arange(cout), torch.arange(cout) % cin, kh // 2, kw // 2] = 1.0

    def identity_norm(norm):
        norm.weight.fill_(1.0)
        norm.bias.zero_()
        norm.running_mean.zero_()
        norm.running_var.fill_(1.0)

    with torch.no_grad():
        dirac_replicated(model.stem_conv.weight)
        identity_norm(model.stem_norm)
        for stage, _, name in model.blocks:
            if stage >= position:
                continue
            block = getattr(model, name)
            for conv in ("conv1", "conv2", "conv3"):
                if hasattr(block, conv):
                    getattr(block, conv).weight.zero_()
            if block.downsample_conv is not None:
                dirac_replicated(block.downsample_conv.weight)
            for norm in ("bn1", "bn2", "bn3", "downsample_norm"):
                if getattr(block, norm, None) is not None:
                    identity_norm(getattr(block, norm))


class MaliciousTransformerServer(HonestServer):
    """Decepticon's server: rewires a transformer's parameters for the analytic token
    readout (reference: servers.py:384-523; ``transformer_rewiring.py``)."""

    THREAT = "Malicious (parameters)"

    def vet_model(self, model):
        from .transformer_rewiring import reconfigure_transformer

        model, secrets = reconfigure_transformer(model, self.loss, self.cfg_server, self.cfg_data, self.setup,
                                                 external_dataloader=self.external_dataloader)
        self.secrets.update(secrets)
        self.model = model
        return model


class MaliciousClassParameterServer(HonestServer):
    """"Fishing" server: a multi-query protocol that isolates single examples by editing
    the classification head (reference: servers.py:526-895). The head is the
    ``nn.Linear`` of ``head_name``, weight (classes, features): the JAX package's
    ``kernel[:, targets]`` is ``weight[targets, :]`` here."""

    THREAT = "Malicious (parameters)"

    def __init__(self, model, loss_fn, cfg_case, setup, external_dataloader=None):
        super().__init__(model, loss_fn, cfg_case, setup, external_dataloader)
        self.original_params = {k: v.detach().clone() for k, v in model.named_parameters()}

    def reset_model(self):
        with torch.no_grad():
            for name, param in self.model.named_parameters():
                param.copy_(self.original_params[name])

    # -------------------------------------------------------------- head edits

    def _edit_head(self, fn):
        """The original parameters, then the head's (weight, bias) replaced by
        ``fn(weight, bias)`` of the original head."""
        self.reset_model()
        head = self.model.get_submodule(head_name(self.model))
        with torch.no_grad():
            weight, bias = fn(head.weight.detach().clone(), head.bias.detach().clone())
            head.weight.copy_(weight)
            head.bias.copy_(bias)

    def reconfigure_for_class_attack(self, target_classes=None):
        """Constant weight rows for the target classes, a large bias elsewhere
        (reference: servers.py:853-870)."""
        cfg = self.cfg_server
        targets = wrap_indices(cfg.target_cls_idx if target_classes is None else target_classes)

        def fn(weight, bias):
            masked_w = torch.zeros_like(weight)
            masked_w[targets, :] = float(cfg.class_multiplier)
            masked_b = torch.full_like(bias, float(cfg.bias_multiplier))
            masked_b[targets] = bias[targets]
            return masked_w, masked_b

        self._edit_head(fn)

    def reconfigure_for_feature_attack(self, feature_val, feature_loc, target_classes=None,
                                       allow_reset_param_weights=False):
        """One weight at (class, feature), the class's bias at -feature_val times
        ``feat_multiplier`` (reference: servers.py:872-895)."""
        cfg = self.cfg_server
        targets = wrap_indices(cfg.target_cls_idx if target_classes is None else target_classes)
        locs = wrap_indices(feature_loc)
        mult = 1.0 if (allow_reset_param_weights and cfg.get("reset_param_weights")) else float(cfg.feat_multiplier)

        def fn(weight, bias):
            masked_w = torch.zeros_like(weight)
            for cls in targets:
                masked_w[cls, locs] = mult
            masked_b = torch.full_like(bias, float(cfg.bias_multiplier))
            masked_b[targets] = -float(feature_val) * float(cfg.feat_multiplier)
            return masked_w, masked_b

        self._edit_head(fn)

    # -------------------------------------------------------------- protocols

    def run_protocol(self, user, additional_users=None, run_honest_protocol=False):
        if run_honest_protocol:
            return super().run_protocol(user)
        if additional_users is not None:
            return self.run_protocol_feature_estimation(user, additional_users)
        return self.run_protocol_binary_attack(user)

    def _head_bias_grad(self, gradients):
        return head_grads(gradients, self.model)[1]

    def run_protocol_binary_attack(self, user):
        """The class attack, and under a class collision a search over one feature's cutoff
        (reference: run_protocol_binary_attack, servers.py:558-682)."""
        cfg = self.cfg_server
        server_payload = self.distribute_payload()
        if cfg.query_once_for_labels:
            shared_data, true_user_data = user.compute_local_updates(server_payload)
            if shared_data["metadata"]["labels"] is not None:
                t_labels = torch.as_tensor(shared_data["metadata"]["labels"]).cpu().numpy().reshape(-1)
            else:
                b_grad = self._head_bias_grad(shared_data["gradients"]).detach().cpu().numpy()
                t_labels = self._recover_labels(b_grad, int(shared_data["metadata"]["num_data_points"] or 1))
            log.info(f"Found labels {t_labels.tolist()} in first query.")
        else:
            t_labels = np.random.default_rng(0).choice(np.arange(self.cfg_data.classes), user.num_data_points)
            shared_data, true_user_data = user.compute_local_updates(server_payload)
            log.info(f"Randomly attacking labels {t_labels.tolist()}.")

        num_data = int(shared_data["metadata"]["num_data_points"] or len(t_labels))
        target_cls = int(np.unique(t_labels)[int(cfg.target_cls_idx)])
        target_indx = np.nonzero(t_labels == target_cls)[0]
        all_labels = torch.as_tensor(t_labels)

        if cfg.get("opt_on_avg_grad"):
            self.reconfigure_for_class_attack(target_classes=list(np.unique(t_labels)))
            payload = self.distribute_payload()
            shared, _ = user.compute_local_updates(payload)
            final_shared, final_payload = [shared], [payload]
        elif len(target_indx) == 1:
            log.info(f"Attacking label {target_cls} with cls attack.")
            self.reconfigure_for_class_attack(target_classes=target_cls)
            payload = self.distribute_payload()
            shared, _ = user.compute_local_updates(payload)
            shared["metadata"] = dict(shared["metadata"], num_data_points=1, labels=torch.tensor([target_cls]))
            final_shared, final_payload = [shared], [payload]
            self.secrets["ClassAttack"] = dict(num_data=1, target_indx=target_indx, true_num_data=num_data,
                                               all_labels=all_labels)
        else:
            log.info(f"Attacking label {target_cls} with binary attack ({len(target_indx)} collisions).")
            self.reconfigure_for_class_attack(target_classes=target_cls)
            payload = self.distribute_payload()
            tmp_shared, _ = user.compute_local_updates(payload)
            avg_feature = _as_numpy(reconstruct_feature(tmp_shared, target_cls, self.model))

            single_grads, feature_loc = None, -1
            masked_feature = avg_feature.copy()
            while single_grads is None:
                feature_loc = int(np.argmax(masked_feature))
                attack_state = dict(feature_loc=feature_loc, feature_val=float(masked_feature[feature_loc]),
                                    num_target_data=len(target_indx), num_data_points=num_data)
                if cfg.get("one_shot_binary_attack", True):
                    single_grads = self.one_shot_binary_attack(user, target_cls, attack_state)
                else:  # the recursive search recovers every colliding example
                    single_grads = self.binary_attack(user, target_cls, attack_state)
                if single_grads is None:  # too many queries on this feature: try the next
                    masked_feature[feature_loc] = -1000.0
                    log.info(f"Feature {feature_loc} exhausted after {user.counted_queries} queries; "
                             f"trying the next one.")

            self.reconfigure_for_feature_attack(attack_state["feature_val"], feature_loc, target_classes=target_cls,
                                                allow_reset_param_weights=True)
            payload = self.distribute_payload()
            # single_grads is ordered most-confident-first (largest feature first)
            grad_i = single_grads[int(cfg.grad_idx)]
            shared = dict(gradients=grad_i, buffers=tmp_shared["buffers"],
                          metadata=dict(tmp_shared["metadata"], num_data_points=1,
                                        labels=torch.tensor([target_cls])))
            final_shared, final_payload = [shared], [payload]
            self.secrets["ClassAttack"] = dict(
                num_data=1, target_indx=target_indx[int(cfg.grad_idx):int(cfg.grad_idx) + 1],
                true_num_data=num_data, all_labels=all_labels)

        log.info(f"User {user.user_idx} was queried {user.counted_queries} times.")
        self.reset_model()
        return final_shared, final_payload, true_user_data

    def _query_feature(self, user, cls_to_obtain, cutoff, feature_loc):
        """One query with the feature head at ``cutoff``: (the shared data, the response,
        the mean feature at ``feature_loc`` of the examples that contributed)."""
        self.reconfigure_for_feature_attack(cutoff, feature_loc, target_classes=cls_to_obtain)
        shared, _ = user.compute_local_updates(self.distribute_payload())
        return shared, float(_as_numpy(reconstruct_feature(shared, cls_to_obtain, self.model))[feature_loc])

    def one_shot_binary_attack(self, user, cls_to_obtain, attack_state):
        """Fixpoint iteration on the feature cutoff: a query at the current subset's mean
        shrinks the contributing subset until its mean repeats within ``feat_threshold``,
        at most 32 queries (reference: servers.py:716-739)."""
        cfg = self.cfg_server
        feature_loc = attack_state["feature_loc"]
        feature_val = attack_state["feature_val"]
        all_vals = []
        for _ in range(32):
            all_vals.append(feature_val)
            shared, feature_val = self._query_feature(user, cls_to_obtain, feature_val, feature_loc)
            if check_with_tolerance(feature_val, all_vals, threshold=float(cfg.feat_threshold)):
                break
        attack_state["feature_val"] = feature_val
        return [self._rescale_to_cumulative(shared["gradients"], attack_state["num_data_points"])]

    def _rescale_to_cumulative(self, grads, num_data_points):
        """Undo the user's mean over ``num_data_points`` examples, of which only those below
        the cutoff contributed, and ``feat_multiplier`` on every entry but the head's bias
        (reference: 735-738)."""
        _, head_bias = head_keys(self.model)
        feat_multiplier = float(self.cfg_server.feat_multiplier)
        return {k: g * num_data_points if k == head_bias else g * num_data_points / feat_multiplier
                for k, g in grads.items()}

    def binary_attack(self, user, cls_to_obtain, attack_state):
        """Recursive bisection of the cutoff: one gradient for every colliding example of
        the target class (reference: binary_attack and binary_attack_recursion,
        servers.py:741-826; the mechanics in ``breaching_tpu``'s docstring). Returns the
        single gradients most-confident-first, or None after max(n², 4) queries without n
        distinct subsets."""
        thresh = float(self.cfg_server.feat_threshold)
        loc = attack_state["feature_loc"]
        n_target = attack_state["num_target_data"]
        num_data_points = attack_state["num_data_points"]
        max_queries = max(n_target ** 2, 4)

        accepted, visited_responses = [], []  # (cutoff, cumulative gradient), responses
        queries = 0
        frontier = [attack_state["feature_val"]]
        while frontier and len(accepted) < n_target and queries < max_queries:
            next_frontier = []
            for cutoff in frontier:
                if len(accepted) >= n_target or queries >= max_queries:
                    break
                shared, response = self._query_feature(user, cls_to_obtain, cutoff, loc)
                queries += 1
                if not np.isfinite(response) or abs(response) < 1e-12:
                    continue  # an empty subset: nothing below this cutoff
                if not check_with_tolerance(response, visited_responses, thresh):
                    visited_responses.append(response)
                    if not check_with_tolerance(cutoff, [c for c, _ in accepted], thresh):
                        accepted.append((cutoff, self._rescale_to_cumulative(shared["gradients"], num_data_points)))
                    mirror = 2 * cutoff - response  # bisect inside the lower subset and mirror above it
                    for cand in (response, mirror, (cutoff + mirror) / 2, (cutoff + response) / 2):
                        if not check_with_tolerance(cand, visited_responses + next_frontier, thresh):
                            next_frontier.append(cand)
            frontier = next_frontier
        log.info(f"Binary attack: {len(accepted)} distinct subsets from {queries} queries (target {n_target}).")
        if len(accepted) < n_target:
            return None
        # ascending cutoffs: each later cumulative gradient adds one more example above
        accepted.sort(key=lambda item: item[0])
        singles = [accepted[0][1]]
        for (_, cum), (_, prev) in zip(accepted[1:], accepted[:-1]):
            singles.append({k: cum[k] - prev[k] for k in cum})
        return list(reversed(singles))

    def estimate_feat(self, additional_users, target_class=None):
        """The target class's features over the users that hold it (reference:
        servers.py:828-851): (features (features, users), the class's count per user)."""
        target_class = int(self.cfg_server.target_cls_idx if target_class is None else target_class)
        est_features, sample_sizes = [], []
        for user in additional_users:
            shared, _ = user.compute_local_updates(self.distribute_payload())
            labels = shared["metadata"]["labels"]
            labels = np.asarray([]) if labels is None else torch.as_tensor(labels).cpu().numpy().reshape(-1)
            num_target = int((labels == target_class).sum())
            if num_target:
                est_features.append(_as_numpy(reconstruct_feature(shared, target_class, self.model)))
                sample_sizes.append(num_target)
        if not est_features:
            raise ValueError(f"These additional users do not own images from class {target_class}.")
        return np.vstack(est_features).T, np.asarray(sample_sizes)

    def run_protocol_feature_estimation(self, target_user, additional_users):
        """Estimate the feature distribution on other users, then cut the target user at
        a quantile of it (reference: servers.py:684-714)."""
        from scipy import stats as scipy_stats

        cfg = self.cfg_server
        log.info(f"Estimating feature distribution from {len(additional_users)} users.")
        self.reconfigure_for_class_attack()
        est_features, est_sizes = self.estimate_feat(additional_users)
        feature_loc = find_best_feat(est_features, est_sizes, method="kstest")
        est_mean, est_std = estimate_gt_stats(est_features, est_sizes, indx=feature_loc)

        expected_points = float(np.sum(est_sizes)) / len(additional_users)
        if expected_points == 1:
            feature_val = float(cfg.class_multiplier)
        else:
            quantile = 1 / expected_points * float(cfg.reweight_collisions)
            feature_val = float(scipy_stats.norm.ppf(quantile, est_mean, max(est_std, 1e-8)))
        log.info(f"Feature {feature_loc}: mu={est_mean:2.4f}, std={est_std:2.4f}, "
                 f"cutoff {feature_val:2.4f} for {expected_points} expected points.")

        self.reconfigure_for_feature_attack(feature_val, feature_loc)
        payload = self.distribute_payload()
        shared, true_user_data = target_user.compute_local_updates(payload)
        self.reconfigure_for_feature_attack(feature_val, feature_loc, allow_reset_param_weights=True)
        true_user_data["distribution"] = est_features[feature_loc]
        return [shared], [payload], true_user_data

    def _recover_labels(self, bias_grad, num_data):
        bias = np.asarray(bias_grad).copy()
        valid = np.nonzero(bias < 0)[0]
        selected = valid.tolist()
        m_impact = bias[valid].sum() / max(num_data, 1)
        bias[valid] -= m_impact
        while len(selected) < num_data:
            idx = int(np.argmin(bias))
            selected.append(idx)
            bias[idx] -= m_impact
        return np.sort(np.asarray(selected[:num_data]))


def _as_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy().reshape(-1)
