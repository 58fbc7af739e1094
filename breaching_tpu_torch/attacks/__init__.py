"""Attack factory (reference: breaching/attacks/__init__.py:12-34)."""

from .analytic_attack import AnalyticAttacker, AprilAttacker, ImprintAttacker
from .decepticon_attack import DecepticonAttacker
from .multiscale_optimization_attack import MultiScaleOptimizationAttacker
from .optimization_based_attack import OptimizationBasedAttacker
from .optimization_permutation_attack import OptimizationPermutationAttacker
from .optimization_with_label_attack import OptimizationJointAttacker
from .recursive_attack import RecursiveAttacker

ATTACKS = {
    "optimization": OptimizationBasedAttacker,
    "multiscale": MultiScaleOptimizationAttacker,
    "joint-optimization": OptimizationJointAttacker,
    "permutation-optimization": OptimizationPermutationAttacker,
    "analytic": AnalyticAttacker,
    "april-analytic": AprilAttacker,
    "imprint-readout": ImprintAttacker,
    "decepticon-readout": DecepticonAttacker,
    "recursive": RecursiveAttacker,
}


def prepare_attack(model, loss, cfg_attack, setup):
    attack_type = cfg_attack.attack_type
    if attack_type in ATTACKS:
        return ATTACKS[attack_type](model, loss, cfg_attack, setup)
    raise NotImplementedError(f"Attack type {attack_type} is not ported yet.")


__all__ = ["prepare_attack", "AnalyticAttacker", "AprilAttacker", "DecepticonAttacker", "ImprintAttacker",
           "OptimizationBasedAttacker", "OptimizationJointAttacker", "OptimizationPermutationAttacker",
           "MultiScaleOptimizationAttacker", "RecursiveAttacker"]
