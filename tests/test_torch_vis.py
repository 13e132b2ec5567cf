"""The port's visualization tools (``evox_tpu_torch/vis_tools``) and
``EvalMonitor.plot`` against the JAX package's, on the CPU.

* **exv**: the counterparts of ``tests/test_vis_and_ext.py``'s three exv
  tests; for the same numpy inputs the port's file is byte for byte the JAX
  writer's (header JSON included), tensors and non-contiguous views write
  the same bytes, and each package's ``read_exv`` reads the other's file;
  a bfloat16 history is refused with JAX's ``ValueError``.
* **plot**: the counterparts of the four plot tests, and every figure
  compared with the JAX package's trace by trace under the same stand-in
  for ``plotly.graph_objects`` (a copy of the JAX test's fixture), for 1,
  2 and 3 objectives, static and animated, with and without a Pareto
  front.  Tolerance: none.  Every number in a figure is copied from the
  history or is a numpy reduction (min, mean, max, padded range) of the
  same float32 arrays in both packages, so the figures are equal exactly.
* **EvalMonitor.plot**: both monitors given the same injected history
  (``source="eval"`` and ``"pop"``, a maximizing monitor, the
  warn-and-``None`` cases and the refusal of an unknown source), and a
  history filled by a fused ``run(n)``.
"""

import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evox_tpu.vis_tools import exv as jexv  # noqa: E402
from evox_tpu.vis_tools import plot as jplot  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import eval_monitor as jeval_monitor  # noqa: E402

from evox_tpu_torch.algorithms import NSGA2, PSO  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2, Ackley  # noqa: E402
from evox_tpu_torch.vis_tools import EvoXVisionAdapter, exv, new_exv_metadata, plot, read_exv  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402
from evox_tpu_torch.workflows.eval_monitor import HistoryType  # noqa: E402


def _write(module, path, pops, fits, as_field=lambda a: a.tobytes()):
    adapter = module.EvoXVisionAdapter(path)
    adapter.set_metadata(module.new_exv_metadata(pops[0], pops[1], fits[0], fits[1]))
    adapter.write_header()
    for p, f in zip(pops, fits):
        adapter.write(as_field(p), as_field(f))
    adapter.close()
    return path.read_bytes()


def _run_data(seed=0, gens=5, n=8, d=4, m=2, first_n=None):
    rng = np.random.RandomState(seed)
    sizes = [first_n or n] + [n] * (gens - 1)
    pops = [rng.rand(k, d).astype(np.float32) for k in sizes]
    fits = [rng.rand(k, m).astype(np.float32) if m > 1 else rng.rand(k).astype(np.float32) for k in sizes]
    return pops, fits


# ---------------------------------------------------------------------------
# exv: the counterparts of tests/test_vis_and_ext.py
# ---------------------------------------------------------------------------


def test_exv_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    pops = [torch.from_numpy(rng.rand(8, 4).astype(np.float32)) for _ in range(5)]
    fits = [torch.from_numpy(rng.rand(8, 2).astype(np.float32)) for _ in range(5)]

    path = tmp_path / "run.exv"
    adapter = EvoXVisionAdapter(path)
    adapter.set_metadata(new_exv_metadata(pops[0], pops[1], fits[0], fits[1]))
    adapter.write_header()
    for p, f in zip(pops, fits):
        adapter.write(p, f)
    adapter.close()

    meta_back, iterations = read_exv(path)
    assert meta_back["version"] == "v1"
    assert meta_back["n_objs"] == 2
    assert len(iterations) == 5
    for it, p, f in zip(iterations, pops, fits):
        np.testing.assert_array_equal(it["population"], p.numpy())
        np.testing.assert_array_equal(it["fitness"], f.numpy())


def test_exv_magic_and_header_layout(tmp_path):
    path = tmp_path / "x.exv"
    a = EvoXVisionAdapter(path)
    pop = torch.zeros((2, 3), dtype=torch.float32)
    fit = torch.zeros((2,), dtype=torch.float32)
    a.set_metadata(new_exv_metadata(pop, pop, fit, fit))
    a.write_header()
    a.close()
    raw = path.read_bytes()
    assert raw[:4] == b"exv1"
    header_len = int.from_bytes(raw[4:8], "little")
    assert len(raw) == 8 + header_len


def test_exv_different_init_schema(tmp_path):
    pop1 = torch.zeros((16, 3), dtype=torch.float32)
    pop2 = torch.zeros((8, 3), dtype=torch.float32)
    fit1 = torch.zeros((16,), dtype=torch.float64)
    fit2 = torch.zeros((8,), dtype=torch.float64)
    meta = new_exv_metadata(pop1, pop2, fit1, fit2)
    assert meta["initial_iteration"]["population_size"] == 16
    assert meta["rest_iterations"]["population_size"] == 8
    assert meta["initial_iteration"]["fields"][1]["type"] == "f64"

    path = tmp_path / "y.exv"
    a = EvoXVisionAdapter(path)
    a.set_metadata(meta)
    a.write_header()
    a.write(pop1, fit1)
    a.write(pop2, fit2)
    a.close()
    _, iters = read_exv(path)
    assert iters[0]["population"].shape == (16, 3)
    assert iters[1]["population"].shape == (8, 3)


# ---------------------------------------------------------------------------
# exv against the JAX writer and reader
# ---------------------------------------------------------------------------

EXV_CASES = {
    # name: (dtype of pop, dtype of fit, objectives, first population size)
    "f32_2obj": (np.float32, np.float32, 2, None),
    "f32_1obj": (np.float32, np.float32, 1, None),
    "f64_3obj_first16": (np.float64, np.float64, 3, 16),
    "f16_pop_i32_fit": (np.float16, np.int32, 2, None),
    "u8_pop_i64_fit": (np.uint8, np.int64, 1, 3),
    "u16_u32_u64": (np.uint16, np.uint32, 2, None),
}


@pytest.mark.parametrize("case", sorted(EXV_CASES))
def test_exv_file_is_byte_equal_to_jax(tmp_path, case):
    pdt, fdt, m, first_n = EXV_CASES[case]
    pops, fits = _run_data(seed=3, m=m, first_n=first_n)
    pops = [(p * 200).astype(pdt) for p in pops]
    fits = [(f * 1000).astype(fdt) for f in fits]
    want = _write(jexv, tmp_path / "jax.exv", pops, fits)
    # numpy in, bytes per field: JAX's own calling form.
    assert _write(exv, tmp_path / "np.exv", pops, fits) == want
    # numpy arrays as fields, and tensors.
    assert _write(exv, tmp_path / "arr.exv", pops, fits, as_field=lambda a: a) == want
    tp = [torch.from_numpy(p) for p in pops]
    tf = [torch.from_numpy(f) for f in fits]
    assert _write(exv, tmp_path / "torch.exv", tp, tf, as_field=lambda a: a) == want
    # The header's JSON bytes: key order and separators.
    meta = exv.new_exv_metadata(tp[0], tp[1], tf[0], tf[1])
    assert meta == jexv.new_exv_metadata(pops[0], pops[1], fits[0], fits[1])


def test_exv_non_contiguous_views_write_row_major_bytes(tmp_path):
    pops, fits = _run_data(seed=4, n=6, d=5, m=3)
    want = _write(jexv, tmp_path / "jax.exv", pops, fits)
    # Each as a transposed view of its transpose, and as a strided slice.
    views_p = [torch.from_numpy(np.ascontiguousarray(p.T)).T for p in pops]
    wide = [torch.from_numpy(np.repeat(f, 2, axis=1)) for f in fits]
    views_f = [w[:, ::2] for w in wide]
    assert not views_p[0].is_contiguous() and not views_f[0].is_contiguous()
    assert _write(exv, tmp_path / "views.exv", views_p, views_f, as_field=lambda a: a) == want


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_read_exv_reads_the_other_packages_file(tmp_path, writer):
    pops, fits = _run_data(seed=5, m=2, first_n=12)
    path = tmp_path / f"{writer}.exv"
    _write(jexv if writer == "jax" else exv, path, pops, fits)
    meta_j, it_j = jexv.read_exv(path)
    meta_t, it_t = read_exv(path)
    assert meta_j == meta_t
    assert len(it_j) == len(it_t) == len(pops)
    for a, b, p, f in zip(it_j, it_t, pops, fits):
        for k in ("population", "fitness"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(b["population"], p)
        np.testing.assert_array_equal(b["fitness"], f)


def test_a_torn_trailing_chunk_is_dropped_as_jax_drops_it(tmp_path):
    pops, fits = _run_data(seed=6)
    raw = _write(exv, tmp_path / "full.exv", pops, fits)
    torn = tmp_path / "torn.exv"
    torn.write_bytes(raw[:-5])
    assert len(read_exv(torn)[1]) == len(jexv.read_exv(torn)[1]) == len(pops) - 1


def _message(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def test_bfloat16_is_refused_with_jax_value_error(tmp_path):
    pop = np.zeros((4, 3), np.float32)
    fit = np.zeros((4,), np.float32)
    want = _message(lambda: jexv.new_exv_metadata(
        jnp.asarray(pop, jnp.bfloat16), jnp.asarray(pop, jnp.bfloat16), jnp.asarray(fit), jnp.asarray(fit)))
    assert want == (ValueError, "Unsupported dtype: bfloat16")
    got = _message(lambda: new_exv_metadata(
        torch.zeros(4, 3, dtype=torch.bfloat16), torch.zeros(4, 3, dtype=torch.bfloat16),
        torch.zeros(4), torch.zeros(4)))
    assert got == want
    # A dtype numpy has but the format does not name: the same message.
    assert _message(lambda: new_exv_metadata(
        torch.zeros(4, 3, dtype=torch.int8), torch.zeros(4, 3, dtype=torch.int8), torch.zeros(4), torch.zeros(4))) \
        == _message(lambda: jexv.new_exv_metadata(pop.astype(np.int8), pop.astype(np.int8), fit, fit))

    # A bfloat16 PSO's history, written chunk by chunk.
    mon = EvalMonitor(full_sol_history=True)
    wf = StdWorkflow(PSO(8, -torch.ones(3), torch.ones(3), device="cpu", dtype=torch.bfloat16), Ackley(),
                     monitor=mon)
    wf.step(wf.init_step(wf.init(0)))
    sols, fits = mon.get_solution_history(), mon.get_fitness_history()
    assert sols[0].dtype == fits[0].dtype == torch.bfloat16
    assert _message(lambda: new_exv_metadata(sols[0], sols[1], fits[0], fits[1])) == want
    adapter = EvoXVisionAdapter(tmp_path / "bf16.exv")
    adapter.set_metadata(new_exv_metadata(pop, pop, fit, fit))
    adapter.write_header()
    assert _message(lambda: adapter.write(sols[0], fits[0])) == want
    adapter.close()


def test_exv_refusals_keep_jax_exception_types(tmp_path):
    a, j = EvoXVisionAdapter(tmp_path / "a.exv"), jexv.EvoXVisionAdapter(tmp_path / "j.exv")
    assert _message(a.write_header) == _message(j.write_header)
    assert _message(lambda: a.write(b"")) == _message(lambda: j.write(b""))
    a.close()
    j.close()
    bad = tmp_path / "bad.exv"
    bad.write_bytes(b"exv0" + bytes(8))
    assert _message(lambda: read_exv(bad)) == _message(lambda: jexv.read_exv(bad))


# ---------------------------------------------------------------------------
# plot
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_plotly(monkeypatch):
    """A minimal plotly stand-in (the real package is optional and absent in
    this image): graph_objects classes that just record their kwargs, enough
    to compare the figures' structure."""

    class _Trace(dict):
        def __init__(self, **kw):
            super().__init__(**kw)

    class Scatter(_Trace):
        pass

    class Scatter3d(_Trace):
        pass

    class Histogram(_Trace):
        pass

    class Frame(_Trace):
        pass

    class Layout(_Trace):
        pass

    class Figure:
        def __init__(self, data=None, frames=None, layout=None):
            self.data = data
            self.frames = frames
            self.layout = layout

    go = types.ModuleType("plotly.graph_objects")
    for cls in (Scatter, Scatter3d, Histogram, Frame, Layout, Figure):
        setattr(go, cls.__name__, cls)
    plotly = types.ModuleType("plotly")
    plotly.graph_objects = go
    monkeypatch.setitem(sys.modules, "plotly", plotly)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
    return go


def _no_plotly(monkeypatch):
    # ``None`` in sys.modules makes ``import plotly`` raise ImportError.
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)


def assert_same(a, b, where="figure"):
    """Equal structure and exactly equal values: numpy arrays by dtype,
    shape and every element (NaN where NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), (where, type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert type(a).__name__ == type(b).__name__ and a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif hasattr(a, "frames"):
        assert type(a).__name__ == type(b).__name__ == "Figure", where
        for k in ("data", "frames", "layout"):
            assert_same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _histories(m, seed=0, gens=4, n=8):
    rng = np.random.RandomState(seed)
    hist = [rng.rand(n, m).astype(np.float32) if m > 1 else rng.rand(n).astype(np.float32) for _ in range(gens)]
    # An inf-penalized entry early in the run: the padded ranges drop it.
    hist[0][0] = np.inf
    return hist


def test_plot_requires_plotly(monkeypatch):
    _no_plotly(monkeypatch)
    with pytest.raises(ImportError, match="plotly"):
        plot.plot_obj_space_1d([torch.zeros(4)])


def test_plot_static_2d_3d(fake_plotly):
    hist = [torch.rand(8, 2) for _ in range(4)]
    pf = torch.rand(16, 2)
    fig = plot.plot_obj_space_2d(hist, problem_pf=pf, animation=False)
    assert fig.frames is None
    assert len(fig.data) == 2  # PF + overlay
    overlay = fig.data[-1]
    assert len(overlay["x"]) == 8 * 4
    assert list(overlay["marker"]["color"][:8]) == [0] * 8  # gen index

    hist3 = [torch.rand(8, 3) for _ in range(4)]
    fig3 = plot.plot_obj_space_3d(hist3, animation=False)
    assert fig3.frames is None
    assert len(fig3.data) == 1
    assert len(fig3.data[0]["z"]) == 8 * 4

    fig_anim = plot.plot_obj_space_2d(hist, problem_pf=pf)
    assert len(fig_anim.frames) == 4


def test_plot_1d_named_variants(fake_plotly):
    hist = [torch.rand(8) for _ in range(3)]
    static = plot.plot_obj_space_1d_no_animation(hist)
    assert static.frames is None and len(static.data) == 3  # min/mean/max
    anim = plot.plot_obj_space_1d_animation(hist)
    assert len(anim.frames) == 3


def test_monitor_plot_dispatch(fake_plotly):
    """EvalMonitor.plot routes by objective count through vis_tools.plot,
    here with a 3-objective history through the whole workflow; each
    figure equals the JAX package's plot of the same history."""
    mon = EvalMonitor(multi_obj=True, full_fit_history=True)
    wf = StdWorkflow(
        NSGA2(16, 3, torch.zeros(6), torch.ones(6), device="cpu"), DTLZ2(d=6, m=3, device="cpu"), monitor=mon
    )
    wf.step(wf.init_step(wf.init(0)))
    fig = mon.plot(animation=False)
    assert fig is not None and fig.frames is None  # static 3d overlay
    fig_anim = mon.plot()
    assert len(fig_anim.frames) == len(mon.fitness_history)
    hist = [f.numpy() for f in mon.get_fitness_history()]
    assert_same(fig, jplot.plot_obj_space_3d(hist, animation=False))
    assert_same(fig_anim, jplot.plot_obj_space_3d(hist))


PLOT_CASES = [
    # (function, objectives, keyword arguments)
    ("plot_obj_space_1d", 1, {}),
    ("plot_obj_space_1d", 1, {"animation": False, "title": "t"}),
    ("plot_obj_space_1d_animation", 1, {}),
    ("plot_obj_space_1d_no_animation", 1, {}),
    ("plot_obj_space_2d", 2, {}),
    ("plot_obj_space_2d", 2, {"animation": False}),
    ("plot_obj_space_2d", 2, {"pf": True}),
    ("plot_obj_space_2d", 2, {"pf": True, "animation": False}),
    ("plot_obj_space_2d", 2, {"pf": True, "sort_points": True}),
    ("plot_obj_space_3d", 3, {}),
    ("plot_obj_space_3d", 3, {"animation": False}),
    ("plot_obj_space_3d", 3, {"pf": True}),
    ("plot_obj_space_3d", 3, {"pf": True, "animation": False, "scene": {"camera": {"eye": {"x": 2}}}}),
    ("plot_dec_space", 2, {}),
]


@pytest.mark.parametrize("fn,m,kw", PLOT_CASES, ids=[f"{f}-{i}" for i, (f, _, _) in enumerate(PLOT_CASES)])
def test_plot_traces_equal_jax(fake_plotly, fn, m, kw):
    hist = _histories(m, seed=len(kw) + m)
    kw = dict(kw)
    pf = None
    if kw.pop("pf", False):
        pf = np.random.RandomState(9).rand(20, m).astype(np.float32)
        kw["problem_pf"] = pf
    want = getattr(jplot, fn)(hist, **kw)
    got = getattr(plot, fn)([torch.from_numpy(h) for h in hist],
                            **{**kw, **({"problem_pf": torch.from_numpy(pf)} if pf is not None else {})})
    assert_same(got, want)
    # numpy in, as the JAX package is called.
    assert_same(getattr(plot, fn)(hist, **kw), want)


def test_plot_takes_bfloat16_histories_as_their_float32_values(fake_plotly):
    hist = [torch.rand(8, 2).to(torch.bfloat16) for _ in range(3)]
    assert_same(plot.plot_obj_space_2d(hist), jplot.plot_obj_space_2d([h.float().numpy() for h in hist]))


# ---------------------------------------------------------------------------
# EvalMonitor.plot against the JAX package's on the same injected history
# ---------------------------------------------------------------------------


def _inject(jmon, tmon, fits, aux_fits=None):
    """The same history in both monitors: fitness entries, and the
    algorithm's ``"fit"`` record when ``aux_fits`` is given."""
    jhist = jeval_monitor.__monitor_history__[jmon._id_]
    for g, f in enumerate(fits):
        jhist[int(jeval_monitor.HistoryType.FITNESS)].append((g, -1, 0, f))
        tmon._history[HistoryType.FITNESS].append((torch.tensor(g), torch.tensor(-1), 0, torch.from_numpy(f)))
    if aux_fits is not None:
        jmon.aux_keys, tmon.aux_keys = ["fit"], ["fit"]
        for g, f in enumerate(aux_fits):
            jhist[int(jeval_monitor.HistoryType.AUXILIARY)].append((g, -1, 0, f))
            tmon._history[HistoryType.AUXILIARY].append(
                (torch.tensor(g), torch.tensor(-1), 0, torch.from_numpy(f)))


def _both(jmon, tmon, **kw):
    """``(port's result, JAX's result, port's warnings, JAX's warnings)``."""
    out = []
    for mon in (tmon, jmon):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append((mon.plot(**kw), [str(w.message) for w in caught]))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("animation", [True, False])
@pytest.mark.parametrize("with_pf", [False, True])
def test_monitor_plot_equals_jax_on_the_same_history(fake_plotly, m, animation, with_pf):
    jmon, tmon = JEvalMonitor(multi_obj=m > 1), EvalMonitor(multi_obj=m > 1)
    _inject(jmon, tmon, _histories(m, seed=m))
    kw = {"animation": animation}
    if with_pf and m > 1:
        pf = np.random.RandomState(2).rand(10, m).astype(np.float32)
        got = tmon.plot(problem_pf=torch.from_numpy(pf), **kw)
        want = jmon.plot(problem_pf=pf, **kw)
    else:
        got, want, wt, wj = _both(jmon, tmon, **kw)
        assert wt == wj == []
    assert_same(got, want)


def test_monitor_plot_of_a_maximizing_monitor_restores_the_sign(fake_plotly):
    jmon, tmon = JEvalMonitor(), EvalMonitor()
    # What StdWorkflow(opt_direction="max") sets.
    jmon.opt_direction = tmon.opt_direction = -1
    hist = _histories(1, seed=7)
    _inject(jmon, tmon, hist)
    got, want, _, _ = _both(jmon, tmon, animation=False)
    assert_same(got, want)
    np.testing.assert_array_equal(got.data[0]["y"], np.asarray([-np.max(h) for h in hist], np.float32))


@pytest.mark.parametrize("m", [1, 2])
def test_monitor_plot_source_pop_equals_jax(fake_plotly, m):
    jmon, tmon = JEvalMonitor(), EvalMonitor()
    _inject(jmon, tmon, _histories(1, seed=1), aux_fits=_histories(m, seed=5))
    got, want, wt, wj = _both(jmon, tmon, source="pop", animation=False)
    assert wt == wj == [] and got is not None
    assert_same(got, want)
    # The two sources plot different records.
    assert not np.array_equal(got.data[0]["y"], tmon.plot(animation=False).data[0]["y"])


def test_monitor_plot_warns_and_returns_none_as_jax(fake_plotly, monkeypatch):
    # No history at all.
    got, want, wt, wj = _both(JEvalMonitor(), EvalMonitor())
    assert got is None and want is None and wt == wj == ["No fitness history recorded, return None"]

    # source="pop" with an empty record of the algorithm's fitness.
    jmon, tmon = JEvalMonitor(), EvalMonitor()
    _inject(jmon, tmon, _histories(1), aux_fits=[])
    got, want, wt, wj = _both(jmon, tmon, source="pop")
    assert got is None and want is None and wt == wj == ["No data recorded for source='pop', return None"]

    # An unknown source is refused alike.
    with pytest.raises(ValueError) as jerr:
        jmon.plot(source="best")
    with pytest.raises(ValueError) as terr:
        tmon.plot(source="best")
    assert str(terr.value) == str(jerr.value)

    # More than three objectives.
    jmon, tmon = JEvalMonitor(multi_obj=True), EvalMonitor(multi_obj=True)
    _inject(jmon, tmon, _histories(4))
    got, want, wt, wj = _both(jmon, tmon)
    assert got is None and want is None and wt == wj == ["Not supported yet."]

    # plotly missing: the ImportError's message names each package's module.
    _no_plotly(monkeypatch)
    jmon, tmon = JEvalMonitor(), EvalMonitor()
    _inject(jmon, tmon, _histories(1))
    got, want, wt, wj = _both(jmon, tmon)
    assert got is None and want is None
    assert len(wt) == len(wj) == 1
    assert wt[0] == wj[0].replace("evox_tpu.vis_tools", "evox_tpu_torch.vis_tools")
    assert wt[0].startswith("No visualization tool available (evox_tpu_torch.vis_tools.plot requires")


def test_monitor_plot_of_a_fused_run_history(fake_plotly):
    """A history that a fused ``run(n)`` filled through the capture seam:
    the figure's traces are the min/mean/max of ``get_fitness_history()``,
    and equal the JAX package's plot of it."""
    mon = EvalMonitor()
    wf = StdWorkflow(PSO(16, -32 * torch.ones(4), 32 * torch.ones(4), device="cpu"), Ackley(), monitor=mon)
    wf.run(wf.init(0), 6)  # init_step and 5 fused steps
    hist = [f.numpy() for f in mon.get_fitness_history()]
    assert len(hist) == 6
    fig = mon.plot(animation=False)
    for trace, reduce in zip(fig.data, (np.min, np.mean, np.max)):
        np.testing.assert_array_equal(trace["y"], np.asarray([reduce(h) for h in hist]))
    assert_same(fig, jplot.plot_obj_space_1d(hist, animation=False))
    anim = mon.plot()
    assert len(anim.frames) == 6
    assert_same(anim, jplot.plot_obj_space_1d(hist))


def test_monitor_plot_of_a_fused_nsga2_run_with_its_pareto_front(fake_plotly):
    mon = EvalMonitor(multi_obj=True, full_fit_history=True, full_sol_history=True)
    problem = DTLZ2(d=6, m=3, device="cpu")
    wf = StdWorkflow(NSGA2(16, 3, torch.zeros(6), torch.ones(6), device="cpu"), problem, monitor=mon)
    wf.run(wf.init(0), 3)
    pf = problem.pf()
    hist = [f.numpy() for f in mon.get_fitness_history()]
    for animation in (True, False):
        fig = mon.plot(problem_pf=pf, animation=animation)
        assert_same(fig, jplot.plot_obj_space_3d(hist, pf.numpy(), animation=animation))
    assert len(mon.plot(problem_pf=pf).frames) == 3
