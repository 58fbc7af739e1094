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
- the soft sign of b4_adam_box_step: tanhf need not round as PyTorch's tanh does,
  so 4 float32 ulps of each tensor's largest entry, NaN in the same places;
- fused_euclidean (B1 and b2_axpby) against autograd through the plain sums: its
  value 1e-5 of the sums, its gradient one rounding;
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
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (4, 3, 224, 224)])
@pytest.mark.parametrize("offset", [0, 1])
def test_b4_in_place_unaligned_and_nan_match_plain(cuda, shape, offset):
    # offset 1 starts the images 4 bytes into their buffer: the one-element-a-thread kernel
    n = int(np.prod(shape))
    buffer = _randn(n + offset, 6, cuda) * 3
    buffer[offset::101] = float("nan")
    x = buffer[offset:].view(shape)
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    want = image.box_project_plain(x, lo, hi)
    assert _same_bits(ops.box_project(x, lo, hi), want)
    before = ops.box_project.launches
    assert ops.box_project(x, lo, hi, out=x) is x and ops.box_project.launches == before + 1
    assert _same_bits(x, want)


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
    the state after every step. The soft sign takes steps t of 10."""
    st = {k: v.clone() for k, v in inputs.items()}
    vals = [torch.tensor(float("inf"), device=lo.device), torch.empty((), device=lo.device)]
    states = []
    for t, value in enumerate(values, start=1):
        step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** t, bias2=1 - 0.999 ** t)
        soft = ops.soft_sign_scalars(t, 10) if signed == "soft" else None
        step_fn(st["x"], st["grad"], st["mu"], st["nu"], st["best"], lo, hi,
                torch.tensor(value, device=lo.device), *vals, step, signed=signed, soft_scale=soft)
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
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (1, 3, 224, 224), (2, 3, 331, 1007)])
def test_b4_adam_box_step_soft_sign_matches_plain(cuda, shape):
    """The soft sign tanh(g s) / max(s, 1e-3): tanhf need not round as PyTorch's tanh,
    so NaN in the same places and elsewhere 4 float32 ulps of each tensor's largest
    entry, over three steps; the best values equal."""
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    inputs = _adam_inputs(shape, cuda)
    before = ops.adam_box_step.launches
    got = _adam_run(ops.adam_box_step, inputs, [0.5, 0.7, 0.3], lo, hi, "soft")
    assert ops.adam_box_step.launches == before + 3
    want = _adam_run(image.adam_box_step_plain, inputs, [0.5, 0.7, 0.3], lo, hi, "soft")
    for got_step, want_step in zip(got, want):
        assert torch.equal(got_step["best_val"], want_step["best_val"])
        for key in ("x", "mu", "nu", "best"):
            g, w = got_step[key], want_step[key]
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan), key
            tol = 4 * torch.finfo(torch.float32).eps * w[~nan].abs().max()
            assert bool(((g[~nan] - w[~nan]).abs() <= tol).all()), key


@pytest.mark.cuda
def test_fused_euclidean_matches_plain(cuda):
    """B1 forward, b2_axpby backward (one launch each) against autograd through the
    plain sums: the value 1e-5 of the sums, the gradient 2^-22 of max |g| (|r| + |d|)."""
    rec, data = _randn(2_904_970, 1, cuda).requires_grad_(True), _randn(2_904_970, 2, cuda) * 0.5
    before = (ops.matching_sums.launches, ops.axpby.launches)
    value = ops.fused_euclidean(rec, data)
    grad, = torch.autograd.grad(value, rec, torch.tensor(0.37, device=cuda))
    assert (ops.matching_sums.launches, ops.axpby.launches) == (before[0] + 1, before[1] + 1)
    want_value = matching.fused_euclidean_plain(rec, data)
    want, = torch.autograd.grad(want_value, rec, torch.tensor(0.37, device=cuda))
    sums = matching.matching_sums_plain(rec.detach(), data)
    assert abs(value.item() - want_value.item()) <= 1e-5 * 0.5 * (sums[1] + sums[2]).item()
    tol = ONE_ROUNDING * (0.37 * (rec.detach().abs() + data.abs())).max()
    assert bool(((grad - want).abs() <= tol).all())


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
@pytest.mark.parametrize("signed", [True, False])
def test_adam_box_step_trials_matches_plain_per_trial(cuda, signed):
    # the fleet's step tail: one launch for every trial of an 8x1x3x224x224 stack, each
    # trial with its own loss and best value
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    shape, trials = (8, 1, 3, 224, 224), 8
    start = dict(x=_randn(shape, 31, cuda) * 2, grad=_randn(shape, 32, cuda), mu=_randn(shape, 33, cuda) * 0.1,
                 nu=_randn(shape, 34, cuda) ** 2 * 0.01, best=_randn(shape, 35, cuda))
    start["grad"].view(-1)[::997] = float("nan")
    values = torch.linspace(0.4, 0.6, trials, device=cuda)
    best_vals = torch.full((trials,), 0.5, device=cuda)
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    got = {k: v.clone() for k, v in start.items()}
    got_best_val = torch.empty(trials, device=cuda)
    before = ops.adam_box_step.launches
    ops.adam_box_step_trials(got["x"], got["grad"], got["mu"], got["nu"], got["best"], lo, hi, values,
                             best_vals, got_best_val, step, signed=signed)
    assert ops.adam_box_step.launches == before + 1
    want = {k: v.clone() for k, v in start.items()}
    want_best_val = torch.empty(trials, device=cuda)
    for t in range(trials):
        image.adam_box_step_plain(want["x"][t], want["grad"][t], want["mu"][t], want["nu"][t], want["best"][t],
                                  lo, hi, values[t], best_vals[t], want_best_val[t], step, signed)
    for key in ("x", "mu", "nu", "best"):
        assert _same_bits(got[key], want[key]), key
    assert _same_bits(got_best_val, want_best_val)
    assert torch.equal(got_best_val, torch.minimum(values, best_vals))


@pytest.mark.cuda
def test_total_variation_trials_is_one_launch_per_trial(cuda):
    # one launch for the 8 trials of the fleet's stack, each trial a segment; each
    # trial's value is the mean over its own elements, as the JAX fleet's vmap gives,
    # and value and gradient equal a single-trial call's bit for bit
    x = _randn((8, 1, 3, 224, 224), 41, cuda).requires_grad_(True)
    scale = torch.tensor([0.2], device=cuda)
    before = ops.tv_value_and_grad.launches
    values = ops.total_variation_trials(x, scale=scale)
    grad, = torch.autograd.grad(values.sum(), x)
    assert ops.tv_value_and_grad.launches == before + 1 and values.shape == (8,)
    for t in range(8):
        value, want = ops.tv_value_and_grad(x[t].detach(), scale)
        assert _same_bits(values[t].detach(), value) and _same_bits(grad[t], want), t


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p,q", [((8, 1, 3, 224, 224), 1.0, 1.0), ((8, 1, 6, 224, 224), 2.0, 0.5),
                                       ((3, 2, 3, 17, 23), 2.0, 1.0)])
def test_b3_tv_value_and_grad_trials_match_plain_per_trial(cuda, shape, p, q):
    x, scale = _randn(shape, 42, cuda), torch.tensor([0.2], device=cuda)
    values, grad = ops.tv_value_and_grad_trials(x, scale, p, q)
    want_values, want = image.tv_value_and_grad_trials_plain(x, scale, p, q)
    assert values.shape == (shape[0],) and grad.shape == shape
    for t in range(shape[0]):
        _assert_tv_value(values[t], want_values[t])
    if (p, q) in TV_EXACT:
        assert _same_bits(grad, want)
    else:
        assert (grad - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
def test_b3_tv_value_and_grad_trials_on_two_streams(cuda):
    # two trials forms in flight at once on two streams, each with its own workspace:
    # the side stream sleeps first, so the two launches overlap or run out of order
    scale = torch.tensor([0.2], device=cuda)
    stacks = [_randn((8, 1, 3, 224, 224), seed, cuda) for seed in (43, 44)]
    wants = [ops.tv_value_and_grad_trials(x, scale) for x in stacks]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(10_000_000)
        got_side = ops.tv_value_and_grad_trials(stacks[0], scale)
    got_main = ops.tv_value_and_grad_trials(stacks[1], scale)
    torch.cuda.synchronize()
    for got, want in ((got_side, wants[0]), (got_main, wants[1])):
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


@pytest.mark.cuda
def test_b3_tv_value_and_grad_trials_replay_in_a_cuda_graph(cuda):
    # the second replay reads new images: every segment's value is right only if the
    # first replay emptied the partials' slots it read
    scale = torch.tensor([0.2], device=cuda)
    x, other = _randn((8, 1, 3, 224, 224), 45, cuda), _randn((8, 1, 3, 224, 224), 46, cuda)
    wants = [ops.tv_value_and_grad_trials(x, scale), ops.tv_value_and_grad_trials(other, scale)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        values, grad = ops.tv_value_and_grad_trials(x, scale)
    for source, (want_values, want_grad) in zip((x.clone(), other), wants):
        x.copy_(source)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(values, want_values) and _same_bits(grad, want_grad)


@pytest.mark.cuda
def test_axpby_refuses_a_mixed_device_call_in_cpp(cuda):
    # the dispatcher's op checks devices itself, as PyTorch's own ops do: a RuntimeError
    # that names the op, and no plain fallback
    r = _randn(1000, 47, cuda)
    a, b = torch.tensor([-0.7], device=cuda), torch.tensor([1.3], device=cuda)
    before = ops.axpby.launches
    with pytest.raises(RuntimeError, match="breaching::axpby"):
        ops.axpby(a.cpu(), r, b, r.clone())
    with pytest.raises(RuntimeError, match="breaching::axpby"):
        ops.axpby(a, r, b, r.cpu())
    with pytest.raises(ValueError, match="breaching::axpby"):  # float64 x beside float32 y: no form
        ops.axpby(a.double(), r.double(), b.double(), r)
    assert ops.axpby.launches == before


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
    with pytest.raises(RuntimeError, match="breaching::cosine_backward"):  # the sums on the CPU
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
    # (2, 3, 331, 1007) has 2,112 tiles of 32 x 32, more than one wave of blocks: the
    # partials' order is fixed, whichever block finishes last
    x, scale = _randn(shape, 17, cuda), torch.tensor([0.2], device=cuda)
    first = ops.tv_value_and_grad(x, scale)
    values = torch.stack([ops.tv_value_and_grad(x, scale)[0] for _ in range(1000)])
    assert _same_bits(values, first[0].expand(1000))
    assert _same_bits(ops.tv_value_and_grad(x, scale)[1], first[1])


@pytest.mark.cuda
def test_b3_tv_value_and_grad_replays_in_a_cuda_graph(cuda):
    # the second replay reads new images: its value is right only if the first replay
    # emptied the partials' slots it read
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
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (1, 3, 224, 224), (2, 3, 331, 1007)])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_b3_tv_forward_is_the_fused_kernels_value_in_one_launch(cuda, shape, p, q):
    # the value-only form of the fused kernel: its value's bits at scale 1, one launch,
    # and NaN where the plain version has NaN (a pixel that is not finite)
    x, one = _randn(shape, 23, cuda), torch.tensor([1.0], device=cuda)
    for pixel in (None, float("nan"), float("inf")):
        if pixel is not None:
            x[0, 1, -1, -1] = pixel
        before = ops.launch_counts()
        got = ops.tv_forward(x, p, q)
        assert ops.launch_counts() == dict(before, b3_tv_forward=before["b3_tv_forward"] + 1)
        _assert_tv_value(got, image.tv_forward_plain(x, p, q))
        assert _same_bits(got, ops.tv_value_and_grad(x, one, p, q)[0])


@pytest.mark.cuda
def test_b3_tv_forward_replays_in_a_cuda_graph(cuda):
    x, other = _randn((1, 3, 224, 224), 24, cuda), _randn((1, 3, 224, 224), 25, cuda)
    wants = [ops.tv_forward(x), ops.tv_forward(other)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        value = ops.tv_forward(x)
    for source, want in zip((x.clone(), other), wants):
        x.copy_(source)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(value, want)


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
    with pytest.raises(ValueError):  # float16: no form
        ops.tv_value_and_grad(x.half(), scale.half())
    with pytest.raises(RuntimeError, match="breaching::tv_value_and_grad"):  # the scale on the CPU
        ops.tv_value_and_grad(x, scale.cpu())


# ---------------------------------------------------------------- the trials forms
#
# b4_adam_box_step and b2_cosine_backward take every trial of a stack in one launch;
# each trial's result equals its own single call's bits (the same arithmetic per
# element, whatever the launch's geometry).


def _adam_stack(shape, seed, cuda, offset=0):
    """Fresh (x, grad, mu, nu, best) of `shape`, each `offset` floats into its buffer
    (1: off a 16-byte boundary, the scalar form), NaN and signed zeros in the gradient."""
    n = int(np.prod(shape))

    def tensor(k, scale=1.0):
        return (_randn(n + offset, seed + k, cuda) * scale)[offset:].view(shape)

    st = dict(x=tensor(0, 2.0), grad=tensor(1), mu=tensor(2, 0.1), nu=tensor(3) ** 2 * 0.01, best=tensor(4))
    st["grad"].view(-1)[::997] = float("nan")
    st["grad"].view(-1)[1::499] = -0.0
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", [((8, 1, 3, 224, 224), 0), ((3, 2, 3, 17, 23), 0),
                                          ((4, 1, 3, 32, 32), 1), ((2, 1, 1, 1, 10), 0)])
@pytest.mark.parametrize("signed", [True, False, "soft"])
def test_adam_box_step_trials_match_single_calls_bit_for_bit(cuda, shape, offset, signed):
    # one launch for the stack; each trial's candidate, moments, best iterate and best
    # value equal to its own call's bits (losses NaN, infinite, improving, not improving)
    trials = shape[0]
    lo = torch.linspace(-1.0, 0.0, shape[2], device=cuda)
    hi = torch.linspace(0.5, 2.0, shape[2], device=cuda)
    start = _adam_stack(shape, 50, cuda, offset)
    values = torch.tensor([float("nan"), float("inf"), 0.4, 0.6, 0.3, 0.5, 0.45, 0.55][:trials], device=cuda)
    best_vals = torch.full((trials,), 0.5, device=cuda)
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    soft = ops.soft_sign_scalars(3, 10) if signed == "soft" else None
    got = {k: v.clone() for k, v in start.items()}
    got_best = torch.empty(trials, device=cuda)
    before = ops.adam_box_step.launches
    ops.adam_box_step_trials(got["x"], got["grad"], got["mu"], got["nu"], got["best"], lo, hi, values, best_vals,
                             got_best, step, signed=signed, soft_scale=soft)
    assert ops.adam_box_step.launches == before + 1
    for t in range(trials):
        single = {k: v[t].clone() for k, v in start.items()}
        single_best = torch.empty((), device=cuda)
        ops.adam_box_step(single["x"], single["grad"], single["mu"], single["nu"], single["best"], lo, hi,
                          values[t], best_vals[t], single_best, step, signed=signed, soft_scale=soft)
        for key in ("x", "mu", "nu", "best"):
            assert _same_bits(got[key][t], single[key]), (t, key)
        assert _same_bits(got_best[t], single_best), t
    want = {k: v.clone() for k, v in start.items()}
    want_best = torch.empty(trials, device=cuda)
    image.adam_box_step_trials_plain(want["x"], want["grad"], want["mu"], want["nu"], want["best"], lo, hi, values,
                                     best_vals, want_best, step, signed=signed, soft_scale=soft)
    assert _same_bits(got_best, want_best)
    for key in ("x", "mu", "nu", "best"):
        if signed == "soft":  # tanhf: 4 float32 ulps of the largest entry, NaN in the same places
            g, w = got[key], want[key]
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan), key
            assert bool(((g[~nan] - w[~nan]).abs() <= 4 * 2.0 ** -23 * w[~nan].abs().max()).all()), key
        else:
            assert _same_bits(got[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,offset", [(4, 2_904_970, 0), (3, 1001, 0), (2, 1000, 1), (1, 7, 0)])
@pytest.mark.parametrize("wrt_data", [False, True])
def test_cosine_backward_rows_match_single_calls_bit_for_bit(cuda, rows, n, offset, wrt_data):
    # one launch for every row; n % 4 != 0 puts every other row off a 16-byte boundary,
    # offset 1 every row
    r = _randn(rows * n + offset, 51, cuda)[offset:].view(rows, n)
    d = _randn(rows * n + offset, 52, cuda)[offset:].view(rows, n)
    sums = torch.stack([ops.matching_sums(r[t], d[t]) for t in range(rows)])
    g = torch.linspace(0.2, 0.9, rows, device=cuda)
    before = ops.cosine_backward.launches
    got = ops.cosine_backward(sums, g, r, d, wrt_data)
    assert ops.cosine_backward.launches == before + 1 and got.shape == (rows, n)
    assert _same_bits(got, matching.cosine_backward_plain(sums, g, r, d, wrt_data))
    for t in range(rows):
        assert _same_bits(got[t], ops.cosine_backward(sums[t], g[t], r[t], d[t], wrt_data)), t


@pytest.mark.cuda
def test_fused_cosine_similarity_trials_match_single_calls(cuda):
    # the batched trial step's objective: one B1 launch a trial, one backward launch
    rows, n = 4, 2_904_970
    rec = _randn(rows * n, 53, cuda).view(rows, n).requires_grad_(True)
    data = _randn(rows * n, 54, cuda).view(rows, n)
    g = torch.linspace(0.2, 0.9, rows, device=cuda)
    before = (ops.matching_sums.launches, ops.cosine_backward.launches)
    values = ops.fused_cosine_similarity_trials(rec, data)
    grad, = torch.autograd.grad(values, rec, g)
    assert (ops.matching_sums.launches, ops.cosine_backward.launches) == (before[0] + rows, before[1] + 1)
    for t in range(rows):
        r = rec[t].detach().clone().requires_grad_(True)
        value = ops.fused_cosine_similarity(r, data[t])
        want, = torch.autograd.grad(value, r, g[t])
        assert _same_bits(values[t].detach(), value.detach()) and _same_bits(grad[t], want), t


@pytest.mark.cuda
def test_trials_forms_replay_in_a_cuda_graph(cuda):
    # the Adam step's stack and the cosine backward's rows captured once, replayed on new
    # inputs copied into the captured ones
    shape, rows, n = (4, 1, 3, 224, 224), 4, 100_003
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=0.271, bias2=0.002997)
    values, best_vals = torch.tensor([0.4, 0.6, float("nan"), 0.2], device=cuda), torch.full((4,), 0.5, device=cuda)
    r, d = _randn(rows * n, 55, cuda).view(rows, n), _randn(rows * n, 56, cuda).view(rows, n)
    sums, g = torch.stack([ops.matching_sums(r[t], d[t]) for t in range(rows)]), torch.rand(rows, device=cuda)
    static = _adam_stack(shape, 57, cuda)
    static_best = torch.empty(4, device=cuda)

    def run(st, out_best):
        ops.adam_box_step_trials(st["x"], st["grad"], st["mu"], st["nu"], st["best"], lo, hi, values, best_vals,
                                 out_best, step)
        return ops.cosine_backward(sums, g, r, d)

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = run(static, static_best)
    for seed in (58, 59):
        fresh = _adam_stack(shape, seed, cuda)
        want = {k: v.clone() for k, v in fresh.items()}
        want_best = torch.empty(4, device=cuda)
        want_out = run(want, want_best)
        for k, v in fresh.items():
            static[k].copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        for key in ("x", "mu", "nu", "best"):
            assert _same_bits(static[key], want[key]), (seed, key)
        assert _same_bits(static_best, want_best) and _same_bits(static_out, want_out), seed


@pytest.mark.cuda
def test_ops_refuse_in_cpp_what_their_kernels_do_not_take(cuda):
    # each op checks in C++: a RuntimeError naming the op for a tensor on another device,
    # a ValueError for shapes, dtypes and layouts; nothing launches
    x, lo, hi = _randn((2, 1, 3, 8, 8), 60, cuda), torch.zeros(3, device=cuda), torch.ones(3, device=cuda)
    vals = [torch.zeros(2, device=cuda) for _ in range(3)]
    step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
    r = _randn(2000, 61, cuda).view(2, 1000)
    sums = torch.zeros(2, 3, device=cuda)
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="breaching::adam_box_step"):  # values of the wrong length
        ops.adam_box_step_trials(x, x.clone(), x.clone(), x.clone(), x.clone(), lo, hi, vals[0][:1], vals[1],
                                 vals[2], step)
    with pytest.raises(RuntimeError, match="breaching::adam_box_step"):  # the losses on the CPU
        ops.adam_box_step_trials(x, x.clone(), x.clone(), x.clone(), x.clone(), lo, hi, vals[0].cpu(), vals[1],
                                 vals[2], step)
    with pytest.raises(ValueError, match="breaching::adam_box_step"):  # a gradient of another shape
        ops.adam_box_step_trials(x, x[:1].clone(), x.clone(), x.clone(), x.clone(), lo, hi, *vals, step)
    with pytest.raises(ValueError, match="breaching::cosine_backward"):  # g of the wrong length
        ops.cosine_backward(sums, torch.zeros(3, device=cuda), r, r.clone())
    with pytest.raises(ValueError, match="breaching::cosine_backward"):  # rec not contiguous
        ops.cosine_backward(sums, torch.zeros(2, device=cuda), r.t().contiguous().t(), r.clone())
    with pytest.raises(ValueError, match="breaching::matching_sums_into"):  # an out of 4
        ops.matching_sums(r[0], r[1], out=torch.empty(4, device=cuda))
    with pytest.raises(RuntimeError, match="breaching::matching_sums"):  # data on the CPU
        ops.matching_sums(r[0], r[1].cpu())
    with pytest.raises(ValueError, match="breaching::box_project_out"):  # an out of another shape
        ops.box_project(x[0], lo, hi, out=torch.empty(1, 3, 8, 7, device=cuda))
    with pytest.raises(ValueError, match="breaching::box_project"):  # bounds of the wrong length
        ops.box_project(x[0], lo[:2], hi[:2])
    with pytest.raises(ValueError, match="breaching::tv_forward"):  # not a batch of images
        ops.tv_forward(r)
    assert ops.launch_counts() == counts


# ---------------------------------------------------------------- the typed forms
# csrc/precision.cu: the kernels in the types the precision knobs give them. Tolerances:
# - B1's sums: float32 accumulation of widened half-precision terms, 1e-5 of the sum of
#   |terms| (two orders of addition); float64, 1e-12 of it;
# - B2 (the cosine backward, axpby): the same roundings as the plain version in the
#   accumulation type, then one rounding to the output's type: 2^-7 of the largest
#   |value| for bfloat16 (one ulp), 2^-10 for float16, 1e-14 for float64;
# - B3: float64 value 1e-12 relative and gradient 1e-12 of its largest entry; bfloat16
#   (float32 inside, one rounding on store) value and gradient 2^-7 of the largest;
# - B4's clamp is exact; its Adam step on float64 1e-12 of the largest entry (the soft
#   sign's tanh need not round as PyTorch's does), on bfloat16 one bfloat16 ulp.
TYPED_PAIRS = [(torch.bfloat16, torch.float32), (torch.float16, torch.float32), (torch.float32, torch.bfloat16),
               (torch.float64, torch.float64)]
AXPBY_PAIRS = [(torch.float32, torch.bfloat16), (torch.float64, torch.float64)]
OUT_ROUNDING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: ONE_ROUNDING,
                torch.float64: 1e-14}


def _ids(pairs):
    return [f"{str(r).split('.')[1]}-{str(d).split('.')[1]}" for r, d in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("rec_dtype,data_dtype", TYPED_PAIRS, ids=_ids(TYPED_PAIRS))
@pytest.mark.parametrize("n,offset", [(11_380_173, 0), (1_000_003, 1)])
def test_typed_b1_b2_match_plain(cuda, rec_dtype, data_dtype, n, offset):
    r = _randn(n + offset, 70, cuda).to(rec_dtype)[offset:]
    d = _randn(n + offset, 71, cuda).to(data_dtype)[offset:]
    acc = matching.acc_dtype(r)
    rw, dw = r.to(acc), d.to(acc)
    terms = torch.stack([(rw * dw).abs().sum(), (rw * rw).sum(), (dw * dw).sum()])
    before = ops.matching_sums.launches
    got = ops.matching_sums(r, d)
    assert ops.matching_sums.launches == before + 1 and got.dtype == acc
    assert bool(((got - matching.matching_sums_plain(r, d)).abs() <= (1e-12 if acc == torch.float64 else 1e-5)
                 * terms).all())
    g = torch.tensor([0.83], dtype=acc, device=cuda)
    for wrt_data, out_dtype in ((False, rec_dtype),):  # the attack takes d/d rec only
        out = ops.cosine_backward(got, g, r, d, wrt_data)
        want = matching.cosine_backward_plain(got, g, r, d, wrt_data)
        assert out.dtype == want.dtype == out_dtype
        err = (out.to(acc) - want.to(acc)).abs().max().item()
        assert err <= OUT_ROUNDING[out_dtype] * want.to(acc).abs().max().item()
    if (rec_dtype, data_dtype) in AXPBY_PAIRS:
        a, b = torch.tensor([-0.7], dtype=acc, device=cuda), torch.tensor([1.3], dtype=acc, device=cuda)
        out, want = ops.axpby(a, r, b, d), matching.axpby_plain(a, r, b, d)
        assert out.dtype == rec_dtype
        assert (out.to(acc) - want.to(acc)).abs().max().item() <= \
            OUT_ROUNDING[rec_dtype] * want.to(acc).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape,p,q,trials", [((1, 3, 224, 224), 1.0, 1.0, 0), ((2, 3, 17, 23), 2.0, 0.5, 0),
                                               ((4, 1, 3, 224, 224), 1.0, 1.0, 4)])
def test_typed_b3_tv_value_and_grad_matches_plain(cuda, dtype, shape, p, q, trials):
    x = _randn(shape, 72, cuda).to(dtype)
    scale = torch.tensor([0.2], dtype=dtype, device=cuda)
    if trials:
        values, grad = ops.tv_value_and_grad_trials(x, scale, p, q)
        want_values, want_grad = image.tv_value_and_grad_trials_plain(x, scale, p, q)
    else:
        values, grad = ops.tv_value_and_grad(x, scale, p, q)
        want_values, want_grad = image.tv_value_and_grad_plain(x, scale, p, q)
    assert values.dtype == grad.dtype == dtype and values.shape == want_values.shape
    tol = 1e-12 if dtype == torch.float64 else 2.0 ** -7
    assert ((values.double() - want_values.double()).abs() <= tol * want_values.double().abs()).all()
    assert (grad.double() - want_grad.double()).abs().max().item() <= tol * want_grad.double().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("signed", [True, False, "soft"])
def test_typed_b4_match_plain(cuda, dtype, signed):
    acc = matching.acc_dtype(torch.empty(0, dtype=dtype))
    x = (0.5 * _randn((3, 1, 3, 64, 64), 73, cuda)).to(dtype)
    lo = torch.tensor([-0.3, -0.4, -0.5], dtype=dtype, device=cuda)
    hi = torch.tensor([0.3, 0.4, 0.5], dtype=dtype, device=cuda)
    assert torch.equal(ops.box_project(x[0], lo, hi), image.box_project_plain(x[0], lo, hi))
    grad, mu = _randn(x.shape, 74, cuda).to(dtype), (0.1 * _randn(x.shape, 75, cuda)).to(dtype)
    nu, best = (0.01 * _randn(x.shape, 76, cuda).abs()).to(dtype), x.clone()
    values = torch.tensor([0.5, float("nan"), 0.25], dtype=acc, device=cuda)
    best_vals = torch.tensor([1.0, 1.0, 0.1], dtype=acc, device=cuda)
    step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
    soft = ops.soft_sign_scalars(3, 10) if signed == "soft" else None
    got = [t.clone() for t in (x, grad, mu, nu, best)] + [torch.empty(3, dtype=acc, device=cuda)]
    want = [t.clone() for t in (x, grad, mu, nu, best)] + [torch.empty(3, dtype=acc, device=cuda)]
    before = ops.adam_box_step.launches
    ops.adam_box_step_trials(*got[:5], lo, hi, values, best_vals, got[5], step, signed=signed, soft_scale=soft)
    assert ops.adam_box_step.launches == before + 1
    image.adam_box_step_trials_plain(*want[:5], lo, hi, values, best_vals, want[5], step, signed=signed,
                                     soft_scale=soft)
    tol = 1e-12 if dtype == torch.float64 else 2.0 ** -7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert (a.double() - b.double()).abs().max().item() <= tol * b.double().abs().max().item()


@pytest.mark.cuda
def test_typed_forms_refuse_a_type_they_do_not_have(cuda):
    # a ValueError naming the kernel and the types; nothing launches, nothing falls back
    r = _randn(1000, 77, cuda)
    x = _randn((1, 3, 8, 8), 78, cuda)
    counts = ops.launch_counts()
    with pytest.raises(ValueError, match="b1_matching_sums has no form for rec Half, data Double"):
        ops.matching_sums(r.half(), r.double())
    with pytest.raises(ValueError, match="b2_axpby has no form for x BFloat16, y Float"):
        one = torch.ones(1, device=cuda)
        ops.axpby(one, r.bfloat16(), one, r)
    with pytest.raises(ValueError, match="b3_tv_value_and_grad has no form for x Half"):
        ops.tv_value_and_grad(x.half(), torch.ones(1, dtype=torch.half, device=cuda))
    with pytest.raises(ValueError, match="b4_box_project has no form for x Half"):
        ops.box_project(x.half(), torch.zeros(3, dtype=torch.half, device=cuda), torch.ones(3, dtype=torch.half,
                                                                                             device=cuda))
    with pytest.raises(ValueError, match="breaching::adam_box_step: mu must be Double"):
        xd = x.double()
        ops.adam_box_step(xd, xd.clone(), x.clone(), xd.clone(), xd.clone(), xd[0, :, 0, 0].clone(),
                          xd[0, :, 0, 0].clone(), torch.zeros((), dtype=torch.float64, device=cuda),
                          torch.zeros((), dtype=torch.float64, device=cuda),
                          torch.zeros((), dtype=torch.float64, device=cuda), ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1,
                                                                                          0.001))
    assert ops.launch_counts() == counts
