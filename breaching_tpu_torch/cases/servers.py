"""The honest-but-curious FL server (counterpart of ``breaching_tpu/cases/servers.py``).

The payload is a dict of detached tensors copied from the server's model: its
parameters by name, its buffers by name (or None) and the data config.
"""

from __future__ import annotations


def construct_server(model, loss_fn, cfg_case, setup, external_dataloader=None):
    """Server factory (reference: breaching/cases/servers.py:40-61)."""
    name = cfg_case.server.name
    if name in ("honest_but_curious", "honest-but-curious"):
        return HonestServer(model, loss_fn, cfg_case, setup, external_dataloader)
    raise NotImplementedError(f"Server type {name} is not ported yet.")


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
        if model_state not in ("default", "trained", "unchanged", None):
            raise NotImplementedError(f"Model state {model_state} is not ported yet.")

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
