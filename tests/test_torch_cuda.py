"""The port's CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped where there is no CUDA card.  On a machine with
one (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(n * 31 + d)
    u = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    fit = u(n)
    fit[::5] = float("nan")
    args = [
        (u(n, d) * 8 - 4).to(dtype), (u(n, d) - 0.5).to(dtype), u(n, d).to(dtype),
        fit.to(dtype), u(n).to(dtype), u(d).to(dtype),
        torch.full((d,), -2.0, dtype=dtype, device=device),
        torch.full((d,), 2.0, dtype=dtype, device=device),
    ]
    scal = [torch.tensor(v, dtype=dtype, device=device) for v in (0.6, 2.5, 0.8)]
    return args + scal, (u(n, d).to(dtype), u(n, d).to(dtype))


@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(100, 37), (64, 128), (30, 5), (64, 384)])
def test_kernel_matches_plain_version(cuda, n, d, dtype, rand):
    """Exact agreement (values equal, NaN at the same places): the kernel
    rounds like the plain version, operator by operator, without FMA."""
    args, draws = _inputs(n, d, getattr(torch, dtype), cuda)
    kw = dict(seed=77, rand=rand, rand_draws=draws if rand == "input" else None)
    before = fused_pso_move.launches
    got = fused_pso_move(*args, **kw)
    want = fused_pso_move_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_pso_move.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_kernel_refuses_what_it_does_not_take(cuda):
    args, _ = _inputs(8, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        fused_pso_move(*[a.double() for a in args], seed=0)
    bad = list(args)
    bad[1] = torch.empty(4, 8, device=cuda).t()  # (8, 4), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_pso_move(*bad, seed=0)
