"""The port's fused PSO move (``evox_tpu_torch/ops/pso_step.py``) against the
JAX package's ``fused_pso_move`` run in Pallas interpret mode with
caller-supplied draws, as ``tests/test_pso_pallas_kernel.py`` runs it.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel is held against that version on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.ops.pso_step import fused_pso_move as jax_move  # noqa: E402
from evox_tpu_torch.ops.pso_step import (  # noqa: E402
    fused_pso_move,
    fused_pso_move_plain,
)
from evox_tpu_torch.utils import rng  # noqa: E402

W, PHI_P, PHI_G = 0.6, 2.5, 0.8
NAMES = ("pop", "velocity", "local_best_location", "local_best_fit")


def _inputs(n, d, seed, nan=False):
    r = np.random.default_rng(seed)
    f = lambda *s: r.uniform(0, 1, s).astype(np.float32)  # noqa: E731
    x = dict(
        pop=f(n, d) * 8 - 4,  # beyond the bounds ±2
        vel=f(n, d) - 0.5,
        lbl=f(n, d),
        fit=f(n),
        lbf=f(n),
        gbl=f(d),
        rp=f(n, d),
        rg=f(n, d),
        lb=np.full(d, -2.0, np.float32),
        ub=np.full(d, 2.0, np.float32),
    )
    if nan:
        x["fit"][::3] = np.nan
        x["lbf"][1::4] = np.inf
        x["lbf"][2::5] = np.nan
        x["pop"][1, :2] = np.nan
        x["vel"][2, 1] = np.nan
    return x


def _jax(x, dtype):
    j = {k: jnp.asarray(v).astype(dtype) for k, v in x.items()}
    return jax_move(
        j["pop"], j["vel"], j["lbl"], j["fit"], j["lbf"], j["gbl"], j["lb"], j["ub"],
        W, PHI_P, PHI_G, seed=jnp.zeros((1,), jnp.int32),
        rand_draws=(j["rp"], j["rg"]), rand="input", interpret=True,
    )


def _torch(x, dtype, fn=fused_pso_move):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}
    return fn(
        t["pop"], t["vel"], t["lbl"], t["fit"], t["lbf"], t["gbl"], t["lb"], t["ub"],
        W, PHI_P, PHI_G, seed=0, rand_draws=(t["rp"], t["rg"]), rand="input",
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(100, 37), (64, 128), (30, 5), (64, 384)])
def test_plain_move_matches_jax_kernel(dtype, n, d):
    x = _inputs(n, d, seed=n + d)
    want = _jax(x, getattr(jnp, dtype))
    got = _torch(x, getattr(torch, dtype))
    # The JAX test's own tolerance: a few ulps of the working dtype, since
    # XLA may fuse and contract the interpreter's arithmetic differently.
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(NAMES, got, want):
        assert str(g.dtype).split(".")[-1] == dtype, name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), rtol=tol, atol=tol, err_msg=name
        )


def test_nan_fold_and_clip_keep_jax_semantics():
    """NaN fitness never counts as an improvement (the fold compares
    ``fit < lbf``), and a NaN position or velocity stays NaN through the
    clamps (``jnp.clip`` propagates NaN; ``fminf``/``fmaxf`` would not)."""
    x = _inputs(30, 5, seed=3, nan=True)
    want = [np.asarray(w, np.float32) for w in _jax(x, jnp.float32)]
    got = [g.numpy() for g in _torch(x, torch.float32)]
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, equal_nan=True, err_msg=name)
    improved = x["fit"] < x["lbf"]
    assert not improved[::3].any()
    np.testing.assert_array_equal(got[3][improved], x["fit"][improved])
    assert np.isnan(got[0][1, :2]).all() and np.isnan(got[1][1, :2]).all()
    finite = np.isfinite(got[0])
    assert (got[0][finite] >= -2).all() and (got[0][finite] <= 2).all()


def test_bad_rand_modes_raise():
    x = _inputs(8, 3, seed=0)
    t = [torch.from_numpy(x[k]) for k in ("pop", "vel", "lbl", "fit", "lbf", "gbl", "lb", "ub")]
    with pytest.raises(ValueError, match="rand must be"):
        fused_pso_move(*t, W, PHI_P, PHI_G, seed=0, rand="tpu")
    with pytest.raises(ValueError, match="requires rand_draws"):
        fused_pso_move(*t, W, PHI_P, PHI_G, seed=0, rand="input")
    with pytest.raises(ValueError, match="must be"):
        fused_pso_move(t[0][0], *t[1:], W, PHI_P, PHI_G, seed=0)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = _inputs(20, 6, seed=1)
    before = fused_pso_move.launches
    got = _torch(x, torch.float32)
    want = _torch(x, torch.float32, fn=fused_pso_move_plain)
    assert fused_pso_move.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hw_draws_are_the_rng_philox_stream(dtype):
    """``rand="hw"`` on the CPU draws rp/rg from the same Philox stream the
    kernel computes: with w=0, phi_p=1, phi_g=0, x=0 and lbl=1 the new
    velocity is exactly rp, the uniform of Philox word 0."""
    n, d, seed = 12, 9, 2024
    z = torch.zeros((n, d), dtype=dtype)
    inf = torch.full((n,), float("inf"), dtype=dtype)
    _, vel, lbl, lbf = fused_pso_move(
        z, z, torch.ones_like(z), inf, torch.zeros(n, dtype=dtype), torch.zeros(d, dtype=dtype),
        torch.full((d,), -10.0, dtype=dtype), torch.full((d,), 10.0, dtype=dtype),
        0.0, 1.0, 0.0, seed=seed,
    )
    assert torch.equal(vel, rng.uniform(seed, (n, d), dtype, device="cpu"))
    assert torch.equal(lbl, torch.ones_like(z)) and torch.equal(lbf, torch.zeros(n, dtype=dtype))
