"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA device.

These tests need the card (the kernels have no CPU mode) and skip without one.
They import neither JAX nor the JAX package, so they run on a machine with the
card but without JAX, with the JAX-side conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances, each with its reason:
- sums over n float32 terms in two orders: 1e-5 of the sum of |terms|;
- elementwise arithmetic done the same way by kernel and plain version: 2^-22 of
  the largest |value| (one rounding);
- the box clamp does no arithmetic: exact;
- the fused kernels b2_cosine_backward and b4_adam_box_step round every product,
  sum, quotient and square root as their plain versions do (no fused
  multiply-add, IEEE division and square root; the plain Adam step divides by
  device tensors, not by host scalars, which CUDA would turn into products with
  a reciprocal): bit for bit, signed zeros included, NaN in the same places;
- b3_tv_value_and_grad: its gradient likewise bit for bit where p, p-1, q and q-1
  are powers cheap_pow forms exactly, else one rounding; its value, a sum in
  another order, 1e-5 relative, and non-finite where the plain version's is.
"""

import numpy as np
import pytest
import torch

from breaching_tpu_torch import ops
from breaching_tpu_torch.ops import image, matching

ONE_ROUNDING = 2.0 ** -22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(device)


def _same_bits(got, want):
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                              want[~nan].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(2_904_970, 0), (1_000_003, 0), (1_000_003, 1)])
def test_b1_b2_match_plain(cuda, n, offset):
    # offset 1 starts both vectors 4 bytes into their buffers: the unaligned path
    r, d = _randn(n + offset, 1, cuda)[offset:], _randn(n + offset, 2, cuda)[offset:]
    terms = torch.stack([(r * d).abs().sum(), (r * r).sum(), (d * d).sum()])
    before = ops.matching_sums.launches
    got = ops.matching_sums(r, d)
    assert ops.matching_sums.launches == before + 1
    assert bool(((got - matching.matching_sums_plain(r, d)).abs() <= 1e-5 * terms).all())
    a, b = torch.tensor([-0.7], device=cuda), torch.tensor([1.3], device=cuda)
    want = matching.axpby_plain(a, r, b, d)
    assert (ops.axpby(a, r, b, d) - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 331, 1007)])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_b3_matches_plain(cuda, shape, p, q):
    x = _randn(shape, 3, cuda)
    want = image.tv_forward_plain(x, p, q).item()
    assert abs(ops.tv_forward(x, p, q).item() - want) <= 1e-5 * want
    g = torch.tensor([0.37], device=cuda)
    want = image.tv_backward_plain(x, g, p, q)
    assert (ops.tv_backward(x, g, p, q) - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 331, 1007)])
def test_b4_matches_plain(cuda, shape):
    x = _randn(shape, 4, cuda) * 3
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    assert torch.equal(ops.box_project(x, lo, hi), image.box_project_plain(x, lo, hi))


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input(cuda):
    x = _randn((1, 3, 32, 32), 5, cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.tv_forward(x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(2_904_970, 0), (1_000_003, 0), (1_000_003, 1)])
@pytest.mark.parametrize("wrt_data", [False, True])
def test_b2_cosine_backward_matches_plain(cuda, n, offset, wrt_data):
    r, d = _randn(n + offset, 6, cuda)[offset:], _randn(n + offset, 7, cuda)[offset:]
    sums, g = ops.matching_sums(r, d), torch.tensor(0.37, device=cuda)
    before = ops.cosine_backward.launches
    got = ops.cosine_backward(sums, g, r, d, wrt_data)
    assert ops.cosine_backward.launches == before + 1
    assert _same_bits(got, matching.cosine_backward_plain(sums, g, r, d, wrt_data))


def _adam_inputs(shape, cuda):
    grad = _randn(shape, 8, cuda)
    grad.view(-1)[::997] = float("nan")
    grad.view(-1)[1::499] = -0.0
    grad.view(-1)[2::499] = 0.0
    return dict(x=_randn(shape, 9, cuda) * 2, grad=grad, mu=_randn(shape, 10, cuda) * 0.1,
                nu=_randn(shape, 11, cuda) ** 2 * 0.01, best=_randn(shape, 12, cuda))


def _adam_run(step_fn, inputs, values, lo, hi, signed):
    """Three steps from `inputs` with the two best-value buffers swapped after each;
    the state after every step."""
    st = {k: v.clone() for k, v in inputs.items()}
    vals = [torch.tensor(float("inf"), device=lo.device), torch.empty((), device=lo.device)]
    states = []
    for t, value in enumerate(values, start=1):
        step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** t, bias2=1 - 0.999 ** t)
        step_fn(st["x"], st["grad"], st["mu"], st["nu"], st["best"], lo, hi,
                torch.tensor(value, device=lo.device), *vals, step, signed=signed)
        vals.reverse()
        states.append({**{k: v.clone() for k, v in st.items()}, "best_val": vals[0].reshape(1).clone()})
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 331, 1007)])
@pytest.mark.parametrize("signed", [True, False])
def test_b4_adam_box_step_matches_plain(cuda, shape, signed):
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    inputs = _adam_inputs(shape, cuda)
    before = ops.adam_box_step.launches
    got = _adam_run(ops.adam_box_step, inputs, [0.5], lo, hi, signed)[0]
    assert ops.adam_box_step.launches == before + 1
    want = _adam_run(image.adam_box_step_plain, inputs, [0.5], lo, hi, signed)[0]
    for key in ("x", "mu", "nu", "best", "best_val"):
        assert _same_bits(got[key], want[key]), key
    assert bool(torch.isnan(got["x"]).any())  # a NaN gradient, or its sign, gives a NaN candidate


@pytest.mark.cuda
def test_b4_adam_box_step_swaps_best_values_over_three_steps(cuda):
    # the loss improves, does not, then improves: the best iterate is taken, kept, taken
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    inputs = _adam_inputs((1, 3, 32, 32), cuda)
    got = _adam_run(ops.adam_box_step, inputs, [0.5, 0.7, 0.3], lo, hi, True)
    want = _adam_run(image.adam_box_step_plain, inputs, [0.5, 0.7, 0.3], lo, hi, True)
    assert [s["best_val"].item() for s in got] == [0.5, 0.5, torch.tensor(0.3).item()]
    assert torch.equal(got[1]["best"], got[0]["best"])
    for g, w in zip(got, want):
        for key in ("x", "mu", "nu", "best", "best_val"):
            assert _same_bits(g[key], w[key]), key


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream(cuda):
    # the side stream first sleeps: a kernel that lands on it has not run when the
    # default stream (which does not wait for it) reads the candidate back
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    st = _adam_inputs((1, 3, 32, 32), cuda)
    vals = [torch.tensor(float("inf"), device=cuda), torch.empty((), device=cuda)]
    value = torch.tensor(0.5, device=cuda)
    before = st["x"].cpu()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        ops.adam_box_step(st["x"], st["grad"], st["mu"], st["nu"], st["best"], lo, hi, value, *vals,
                          ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001), signed=False)
    seen = st["x"].cpu()
    side.synchronize()
    assert torch.equal(seen, before)
    assert not torch.equal(st["x"].cpu(), before)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    x = _randn((1, 3, 32, 32), 13, cuda)
    lo, hi = torch.zeros(3, device=cuda), torch.ones(3, device=cuda)
    one = torch.zeros((), device=cuda)
    step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
    with pytest.raises(ValueError):  # float64 gradient
        ops.adam_box_step(x, x.double(), x.clone(), x.clone(), x.clone(), lo, hi, one, one.clone(),
                          one.clone(), step)
    with pytest.raises(ValueError):  # one buffer for the best value read and written
        ops.adam_box_step(x, x.clone(), x.clone(), x.clone(), x.clone(), lo, hi, one, one, one, step)
    r = _randn(1000, 14, cuda)
    with pytest.raises(ValueError):  # the sums on the CPU
        ops.cosine_backward(torch.zeros(3), one, r, r.clone())


TV_SHAPES = [(1, 3, 32, 32), (1, 3, 224, 224), (2, 3, 17, 23), (1, 6, 33, 31), (1, 6, 9, 1), (1, 3, 1, 7)]
TV_EXACT = [(1.0, 1.0), (2.0, 1.0), (1.5, 2.0)]  # p, p-1, q, q-1 in {0, 0.5, 1, 1.5, 2}


def _assert_tv_value(got, want):
    got, want = got.item(), want.item()
    if want == want and abs(want) != float("inf"):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    else:
        assert str(got) == str(want), (got, want)  # nan with nan, inf with inf


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TV_SHAPES)
@pytest.mark.parametrize("p,q", TV_EXACT + [(2.0, 0.5)])
def test_b3_tv_value_and_grad_matches_plain(cuda, shape, p, q):
    x, scale = _randn(shape, 15, cuda), torch.tensor([0.2], device=cuda)
    before = ops.tv_value_and_grad.launches
    value, grad = ops.tv_value_and_grad(x, scale, p, q)
    assert ops.tv_value_and_grad.launches == before + 1
    want_value, want = image.tv_value_and_grad_plain(x, scale, p, q)
    assert value.shape == () and grad.shape == x.shape
    _assert_tv_value(value, want_value)
    if (p, q) in TV_EXACT:
        assert _same_bits(grad, want)
    else:
        assert (grad - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 17, 23)])
@pytest.mark.parametrize("place", ["last column", "last row", "column 0", "row 0", "corner"])
@pytest.mark.parametrize("planted", [float("nan"), float("inf"), float("-inf")])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 1.0)])
def test_b3_tv_gradient_non_finite_at_the_boundary_matches_plain(cuda, shape, place, planted, p, q):
    # the plain version's rolls carry a NaN to the wrapped boundary column and row
    x, scale = _randn(shape, 16, cuda), torch.tensor([0.2], device=cuda)
    H, W = shape[-2:]
    h, w = {"last column": (H // 2, W - 1), "last row": (H - 1, W // 2), "column 0": (H // 2, 0),
            "row 0": (0, W // 2), "corner": (H - 1, W - 1)}[place]
    x[-1, -1, h, w] = planted
    want = image.tv_backward_plain(x, scale, p, q)
    got = ops.tv_backward(x, scale, p, q)
    assert torch.equal(torch.isnan(got), torch.isnan(want)), "NaN positions differ"
    assert _same_bits(got, want)
    assert bool(torch.isnan(want).any()) == (planted != planted or p != 1.0)
    value, grad = ops.tv_value_and_grad(x, scale, p, q)
    assert _same_bits(grad, want)
    _assert_tv_value(value, image.tv_forward_plain(x, p, q) * scale.reshape(()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 224, 224), (2, 3, 331, 1007)])
def test_b3_tv_value_and_grad_repeats_its_bits(cuda, shape):
    # (2, 3, 331, 1007) has 7,938 tiles on 1,024 blocks: the partials' order is fixed,
    # whichever block finishes last
    x, scale = _randn(shape, 17, cuda), torch.tensor([0.2], device=cuda)
    first = ops.tv_value_and_grad(x, scale)
    values = torch.stack([ops.tv_value_and_grad(x, scale)[0] for _ in range(1000)])
    assert _same_bits(values, first[0].expand(1000))
    assert _same_bits(ops.tv_value_and_grad(x, scale)[1], first[1])


@pytest.mark.cuda
def test_b3_tv_value_and_grad_replays_in_a_cuda_graph(cuda):
    # the second replay reads new images: its value is written only if the first
    # replay's last block set the ticket counter back to 0
    x, scale = _randn((1, 3, 224, 224), 18, cuda), torch.tensor([0.2], device=cuda)
    other = _randn((1, 3, 224, 224), 19, cuda)
    wants = [ops.tv_value_and_grad(x, scale), ops.tv_value_and_grad(other, scale)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        value, grad = ops.tv_value_and_grad(x, scale)
    for source, (want_value, want_grad) in zip((x.clone(), other), wants):
        x.copy_(source)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(value, want_value) and _same_bits(grad, want_grad)


@pytest.mark.cuda
def test_b3_tv_value_and_grad_launches_on_the_current_stream(cuda):
    # the side stream sleeps, then writes the images: a kernel that ran on another
    # stream would have read them before the write
    x, scale = _randn((1, 3, 32, 32), 20, cuda), torch.tensor([0.2], device=cuda)
    new = _randn((1, 3, 32, 32), 21, cuda)
    want_value, want = image.tv_value_and_grad_plain(new, scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        x.copy_(new)
        value, grad = ops.tv_value_and_grad(x, scale)
    torch.cuda.synchronize()
    assert _same_bits(grad, want)
    _assert_tv_value(value, want_value)


@pytest.mark.cuda
def test_b3_tv_value_and_grad_refuses_what_it_does_not_take(cuda):
    x, scale = _randn((1, 3, 32, 32), 22, cuda), torch.tensor([0.2], device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        ops.tv_value_and_grad(x.transpose(2, 3), scale)
    with pytest.raises(ValueError):  # float64
        ops.tv_value_and_grad(x.double(), scale.double())
    with pytest.raises(ValueError):  # the scale on the CPU
        ops.tv_value_and_grad(x, scale.cpu())
