"""Hand-written CUDA kernels of the attack step, with their plain PyTorch versions."""

from .image import (AdamStep, adam_box_step, adam_box_step_trials, box_project, sign, soft_sign_scalars,
                    total_variation, total_variation_trials, tv_backward, tv_forward,
                    tv_value_and_grad, tv_value_and_grad_trials)
from .matching import (axpby, cosine_backward, fused_cosine_similarity, fused_cosine_similarity_trials,
                       fused_euclidean, matching_sums)

# Every kernel wrapper; each carries a `launches` count of its kernel launches.
KERNELS = {
    "b1_matching_sums": matching_sums,
    "b2_axpby": axpby,
    "b2_cosine_backward": cosine_backward,
    "b3_tv_forward": tv_forward,
    "b3_tv_value_and_grad": tv_value_and_grad,
    "b4_box_project": box_project,
    "b4_adam_box_step": adam_box_step,
}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        wrapper.launches_by_type = {}


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


def launch_counts_by_type() -> dict:
    """"<kernel> <types>" -> launches, e.g. "b1_matching_sums bf16-f32": each form's count."""
    return {f"{name} {types}": n for name, wrapper in KERNELS.items() for types, n in wrapper.launches_by_type.items()}


__all__ = [
    "KERNELS",
    "AdamStep",
    "adam_box_step",
    "adam_box_step_trials",
    "axpby",
    "box_project",
    "cosine_backward",
    "fused_cosine_similarity",
    "fused_cosine_similarity_trials",
    "fused_euclidean",
    "launch_counts",
    "launch_counts_by_type",
    "matching_sums",
    "reset_launch_counts",
    "sign",
    "soft_sign_scalars",
    "total_variation",
    "total_variation_trials",
    "tv_backward",
    "tv_forward",
    "tv_value_and_grad",
    "tv_value_and_grad_trials",
]
