"""Attack factory (reference: breaching/attacks/__init__.py:12-34)."""

from .optimization_based_attack import OptimizationBasedAttacker


def prepare_attack(model, loss, cfg_attack, setup):
    if cfg_attack.attack_type == "optimization":
        return OptimizationBasedAttacker(model, loss, cfg_attack, setup)
    raise NotImplementedError(f"Attack type {cfg_attack.attack_type} is not ported yet.")


__all__ = ["prepare_attack", "OptimizationBasedAttacker"]
