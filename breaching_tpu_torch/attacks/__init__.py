"""Attack factory (reference: breaching/attacks/__init__.py:12-34)."""

from .multiscale_optimization_attack import MultiScaleOptimizationAttacker
from .optimization_based_attack import OptimizationBasedAttacker
from .optimization_with_label_attack import OptimizationJointAttacker


def prepare_attack(model, loss, cfg_attack, setup):
    if cfg_attack.attack_type == "optimization":
        return OptimizationBasedAttacker(model, loss, cfg_attack, setup)
    if cfg_attack.attack_type == "multiscale":
        return MultiScaleOptimizationAttacker(model, loss, cfg_attack, setup)
    if cfg_attack.attack_type == "joint-optimization":
        return OptimizationJointAttacker(model, loss, cfg_attack, setup)
    raise NotImplementedError(f"Attack type {cfg_attack.attack_type} is not ported yet.")


__all__ = ["prepare_attack", "OptimizationBasedAttacker", "OptimizationJointAttacker",
           "MultiScaleOptimizationAttacker"]
