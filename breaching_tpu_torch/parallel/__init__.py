"""The port's multi-device layer (counterpart of ``breaching_tpu/parallel``): meshes of
ranks over ``torch.distributed``, the parameter partition rule and the users over ranks.
``_dist`` starts the process group and holds the collectives; ``dryrun`` runs the
production attack in every ``attack.impl.sharding`` mode against solo."""

from .federated import sharded_user_aggregate
from .mesh import (
    make_attack_mesh,
    make_mesh,
    params_partition_specs,
    shard_pytree,
    sharded_attack_step,
)

__all__ = ["make_attack_mesh", "make_mesh", "params_partition_specs",
           "shard_pytree", "sharded_attack_step", "sharded_user_aggregate"]
