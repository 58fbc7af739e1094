"""Attack factory (reference: breaching/attacks/__init__.py:12-34)."""

from .analytic_attack import AnalyticAttacker, ImprintAttacker
from .multiscale_optimization_attack import MultiScaleOptimizationAttacker
from .optimization_based_attack import OptimizationBasedAttacker
from .optimization_with_label_attack import OptimizationJointAttacker

ATTACKS = {
    "optimization": OptimizationBasedAttacker,
    "multiscale": MultiScaleOptimizationAttacker,
    "joint-optimization": OptimizationJointAttacker,
    "analytic": AnalyticAttacker,
    "imprint-readout": ImprintAttacker,
}


def prepare_attack(model, loss, cfg_attack, setup):
    attack_type = cfg_attack.attack_type
    if attack_type in ATTACKS:
        return ATTACKS[attack_type](model, loss, cfg_attack, setup)
    if attack_type == "april-analytic":
        raise NotImplementedError("Attack type april-analytic (APRIL) is not ported yet: it needs the ViT "
                                  "(vit.py).")
    raise NotImplementedError(f"Attack type {attack_type} is not ported yet.")


__all__ = ["prepare_attack", "AnalyticAttacker", "ImprintAttacker", "OptimizationBasedAttacker",
           "OptimizationJointAttacker", "MultiScaleOptimizationAttacker"]
