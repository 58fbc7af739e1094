"""Hand-written CUDA kernels of the attack step, with their plain PyTorch versions."""

from .image import box_project, total_variation, tv_backward, tv_forward
from .matching import axpby, fused_cosine_similarity, matching_sums

# Every kernel wrapper; each carries a `launches` count of its kernel launches.
KERNELS = {
    "b1_matching_sums": matching_sums,
    "b2_axpby": axpby,
    "b3_tv_forward": tv_forward,
    "b3_tv_backward": tv_backward,
    "b4_box_project": box_project,
}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}


__all__ = [
    "KERNELS",
    "axpby",
    "box_project",
    "fused_cosine_similarity",
    "launch_counts",
    "matching_sums",
    "reset_launch_counts",
    "total_variation",
    "tv_backward",
    "tv_forward",
]
