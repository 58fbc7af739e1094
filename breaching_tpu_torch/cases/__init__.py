"""FL simulation cases: users, servers, models, data."""

from ..utils import model_dtype
from .data import construct_dataloader
from .models.model_preparation import construct_model
from .servers import construct_server
from .users import construct_user


def construct_case(cfg_case, setup, external_dataloader=None):
    """Assemble (user, server, model, loss_fn) for one experiment, the model on
    ``setup["device"]`` in ``utils.model_dtype(setup)`` (reference: breaching/cases/__init__.py:14-22)."""
    model, loss_fn = construct_model(
        cfg_case.model, cfg_case.data, pretrained=cfg_case.server.pretrained,
        generator=setup["generator"])
    model.to(device=setup["device"], dtype=model_dtype(setup))
    server = construct_server(model, loss_fn, cfg_case, setup, external_dataloader)
    model = server.vet_model(model)
    user = construct_user(model, loss_fn, cfg_case, setup)
    return user, server, model, loss_fn


__all__ = [
    "construct_case",
    "construct_dataloader",
    "construct_model",
    "construct_server",
    "construct_user",
]
