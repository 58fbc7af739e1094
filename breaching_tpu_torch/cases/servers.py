"""The honest-but-curious FL server (counterpart of ``breaching_tpu/cases/servers.py``).

The payload is a dict of detached tensors copied from the server's model: its
parameters by name, its buffers by name (or None) and the data config. Before each
payload the server sets its model to ``server.model_state``, as the JAX package's
``reconfigure_model`` does, in place on its model:

- ``default``, ``trained``, ``unchanged``: as loaded;
- ``untrained``: a fresh initialization of the architecture, drawn from a CPU
  generator seeded from the setup's generator and the query's index (the JAX
  package's ``fold_in(split_key(setup), query_id)``), BatchNorm statistics reset;
- ``orthogonal``: the same, then every convolution and dense kernel redrawn as a
  (semi-)orthogonal matrix on the JAX package's axes: the kernel flattened to
  (-1, out) in its HWIO (convolution) or (in, out) (dense) layout, whose columns, or
  rows where it has fewer rows than columns, are orthonormal;
- ``linearized``: every BatchNorm's scale set to its running variance and its bias to
  its running mean + 10, and every biased convolution's bias raised by 10 (dense
  layers keep theirs). Like the JAX package, which runs it on every payload, the
  convolution biases gain 10 per query; the BatchNorm parameters do not, they are
  set from the statistics.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.layers import BatchNorm
from .models.model_preparation import construct_model


def construct_server(model, loss_fn, cfg_case, setup, external_dataloader=None):
    """Server factory (reference: breaching/cases/servers.py:40-61): the honest server and
    the malicious model, transformer and class-parameter servers
    (``cases/malicious/servers.py``)."""
    if cfg_case.server.has_external_data and external_dataloader is None:
        from .data import construct_dataloader

        external_dataloader = construct_dataloader(cfg_case.data, cfg_case.impl, user_idx=None,
                                                   return_full_dataset=True)
    name = cfg_case.server.name
    if name in ("honest_but_curious", "honest-but-curious"):
        return HonestServer(model, loss_fn, cfg_case, setup, external_dataloader)
    if name == "malicious_model":
        from .malicious.servers import MaliciousModelServer

        return MaliciousModelServer(model, loss_fn, cfg_case, setup, external_dataloader)
    if name in ("class_malicious_parameters", "malicious_fishing"):
        from .malicious.servers import MaliciousClassParameterServer

        return MaliciousClassParameterServer(model, loss_fn, cfg_case, setup, external_dataloader)
    if name in ("malicious_transformer", "malicious_transformer_parameters"):
        from .malicious.servers import MaliciousTransformerServer

        return MaliciousTransformerServer(model, loss_fn, cfg_case, setup, external_dataloader)
    raise ValueError(f"Invalid server type {name}.")


class HonestServer:
    """An honest-but-curious server: distributes the model faithfully."""

    THREAT = "Honest-but-curious"

    def __init__(self, model, loss_fn, cfg_case, setup, external_dataloader=None):
        self.model = model
        self.loss = loss_fn
        self.cfg_case = cfg_case
        self.cfg_server = cfg_case.server
        self.cfg_data = cfg_case.data
        self.setup = setup
        self.num_queries = int(cfg_case.server.num_queries)
        self.external_dataloader = external_dataloader
        self.secrets = {}

    def __repr__(self):
        return f"""Server (of type {self.__class__.__name__}) with settings:
    Threat model: {self.THREAT}
    Number of planned queries: {self.num_queries}
    Has external/public data: {self.cfg_server.has_external_data}

    Model: {self.model.name}
    model state: {self.cfg_server.model_state}
    Secrets: {list(self.secrets.keys())}"""

    def reconfigure_model(self, model_state: str, query_id: int = 0):
        if model_state in ("default", "trained", "unchanged", None):
            return
        if model_state in ("untrained", "orthogonal"):
            # the setup's generator gives the base seed; the query's index is folded in
            base = int(torch.randint(2 ** 62, (), generator=self.setup["generator"]))
            generator = torch.Generator().manual_seed(
                int(np.random.SeedSequence([base, int(query_id)]).generate_state(1, np.uint64)[0]))
            self._reinitialize(generator)
            if model_state == "orthogonal":
                _orthogonalize_kernels(self.model, generator)
        elif model_state == "linearized":
            _linearize_batchnorm(self.model)
        else:
            raise ValueError(f"Unknown model state {model_state}.")

    def _reinitialize(self, generator):
        """A fresh initialization of the model's architecture from ``generator``: every
        parameter and buffer, as ``construct_model`` draws them."""
        fresh, _ = construct_model(self.cfg_case.model, self.cfg_data, pretrained=False, generator=generator)
        state = self.model.state_dict()
        with torch.no_grad():
            for name, tensor in fresh.state_dict().items():
                state[name].copy_(tensor)

    def distribute_payload(self, query_id: int = 0):
        self.reconfigure_model(self.cfg_server.model_state, query_id)
        parameters = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        buffers = {k: v.detach().clone() for k, v in self.model.named_buffers()}
        if not (self.cfg_server.provide_public_buffers and buffers):
            buffers = None
        return dict(parameters=parameters, buffers=buffers, metadata=self.cfg_data)

    def vet_model(self, model):
        """An honest server does not modify the model."""
        return self.model

    def queries(self):
        return range(self.num_queries)

    def run_protocol(self, user):
        """Simulate the full FL exchange (reference: servers.py:157-168)."""
        shared_user_data, payloads = [], []
        for query_id in self.queries():
            payload = self.distribute_payload(query_id)
            shared_data, true_user_data = user.compute_local_updates(payload)
            payloads.append(payload)
            shared_user_data.append(shared_data)
        return shared_user_data, payloads, true_user_data


def _orthogonalize_kernels(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw every convolution and dense kernel of ``model`` as a (semi-)orthogonal
    matrix on the JAX package's axes (``jax.nn.initializers.orthogonal`` of the kernel
    flattened to (-1, out)): a standard normal matrix of shape (max, min) of the flat
    shape, its Q factor with the signs of R's diagonal, transposed where the flat
    kernel has fewer rows than columns. Drawn in float64 on the CPU."""
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            out, cin, kh, kw = module.weight.shape
            flat = _orthogonal((kh * kw * cin, out), generator)  # HWIO flattened
            weight = flat.reshape(kh, kw, cin, out).permute(3, 2, 0, 1)
        elif isinstance(module, nn.Linear):
            weight = _orthogonal(tuple(module.weight.shape[::-1]), generator).T  # (in, out)
        else:
            continue
        with torch.no_grad():
            module.weight.copy_(weight)


def _orthogonal(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    rows, cols = shape
    normal = torch.randn(max(rows, cols), min(rows, cols), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(normal)
    q = q * torch.sign(torch.diagonal(r))
    return q.T if rows < cols else q


def _linearize_batchnorm(model: nn.Module) -> None:
    """BatchNorm scale := running variance and bias := running mean + 10; biased
    convolutions' bias += 10 (``breaching_tpu/cases/servers.py`` ``_linearize_batchnorm``)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm):
                module.weight.copy_(module.running_var)
                module.bias.copy_(module.running_mean + 10.0)
            elif isinstance(module, nn.Conv2d) and module.bias is not None:
                module.bias.add_(10.0)
