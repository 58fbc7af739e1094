"""Hand-written CUDA kernels of the attack step, with their plain PyTorch versions."""

from .image import (AdamStep, adam_box_step, box_project, sign, total_variation, tv_backward,
                    tv_forward, tv_value_and_grad)
from .matching import axpby, cosine_backward, fused_cosine_similarity, matching_sums

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


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


__all__ = [
    "KERNELS",
    "AdamStep",
    "adam_box_step",
    "axpby",
    "box_project",
    "cosine_backward",
    "fused_cosine_similarity",
    "launch_counts",
    "matching_sums",
    "reset_launch_counts",
    "sign",
    "total_variation",
    "tv_backward",
    "tv_forward",
    "tv_value_and_grad",
]
