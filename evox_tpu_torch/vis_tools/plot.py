"""Plotly visualization tools (counterpart of
``evox_tpu/vis_tools/plot.py``).

One generic animated-scatter builder drives every per-dimensionality plot
function (decision space, 1/2/3-objective space).  Requires the optional
``plotly`` package, imported on the first call; every entry point raises a
clear ImportError without it (callers like ``EvalMonitor.plot`` catch this
and degrade gracefully).

Histories and Pareto fronts may be numpy arrays or torch tensors on any
device: each is brought to the host by :func:`_host` where the JAX
package calls ``np.asarray``, so the figures hold numpy arrays, as the JAX
package's do.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = [
    "plot_dec_space",
    "plot_obj_space_1d",
    "plot_obj_space_1d_animation",
    "plot_obj_space_1d_no_animation",
    "plot_obj_space_2d",
    "plot_obj_space_3d",
]


def _host(x) -> np.ndarray:
    """``x`` as a numpy array.  A tensor is copied to the host; one of a
    dtype numpy has no counterpart of (bfloat16) is widened to float32
    first, which holds its values exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _go():
    try:
        import plotly.graph_objects as go
    except ImportError as e:  # pragma: no cover - depends on environment
        raise ImportError(
            "evox_tpu_torch.vis_tools.plot requires the optional `plotly` package"
        ) from e
    return go


def _padded_range(v: np.ndarray) -> list:
    # Non-finite entries (inf-penalized fitness early in a run) are dropped;
    # with nothing finite fall back to a unit range instead of a NaN axis.
    v = np.asarray(v)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return [0.0, 1.0]
    lo, hi = float(np.min(v)), float(np.max(v))
    span = hi - lo
    return [lo - 0.1 * span, hi + 0.1 * span]


def _animated_scatter(
    frames_data: Sequence[list],
    layout_kwargs: dict,
    frame_duration: int = 200,
):
    """Build a plotly figure animating ``frames_data`` (a list of trace
    lists) with a play button and per-generation slider — the control
    scaffolding shared by every plot function."""
    go = _go()
    frames = [
        go.Frame(data=data, name=str(i)) for i, data in enumerate(frames_data)
    ]
    steps = [
        {
            "label": i,
            "method": "animate",
            "args": [
                [str(i)],
                {
                    "frame": {"duration": frame_duration, "redraw": False},
                    "mode": "immediate",
                    "transition": {"duration": frame_duration},
                },
            ],
        }
        for i in range(len(frames))
    ]
    sliders = [
        {
            "currentvalue": {"prefix": "Generation: "},
            "pad": {"b": 1, "t": 10},
            "len": 0.8,
            "x": 0.2,
            "y": 0,
            "steps": steps,
        }
    ]
    play_button = {
        "type": "buttons",
        "buttons": [
            {
                "label": "▶",
                "method": "animate",
                "args": [
                    None,
                    {
                        "frame": {"duration": frame_duration, "redraw": False},
                        "fromcurrent": True,
                        "transition": {"duration": frame_duration},
                    },
                ],
            }
        ],
        "x": 0.05,
        "y": 0,
        "pad": {"t": 10},
    }
    fig = go.Figure(
        data=frames_data[0],
        frames=frames,
        layout=go.Layout(sliders=sliders, updatemenus=[play_button], **layout_kwargs),
    )
    return fig


def plot_dec_space(population_history: List[np.ndarray], **kwargs):
    """Animated 2-D decision-space scatter of the population per generation."""
    go = _go()
    population_history = [_host(p) for p in population_history]
    all_pop = np.concatenate(population_history, axis=0)
    frames = [
        [go.Scatter(x=p[:, 0], y=p[:, 1], mode="markers", marker={"color": "#636EFA"})]
        for p in population_history
    ]
    return _animated_scatter(
        frames,
        dict(
            xaxis={"range": _padded_range(all_pop[:, 0])},
            yaxis={"range": _padded_range(all_pop[:, 1])},
            **kwargs,
        ),
    )


def plot_obj_space_1d(
    fitness_history: List[np.ndarray], animation: bool = True, **kwargs
):
    """Single-objective fitness over generations: min/mean/max curves, or an
    animated per-generation histogram when ``animation``."""
    go = _go()
    fitness_history = [_host(f).reshape(-1) for f in fitness_history]
    if not animation:
        gens = np.arange(len(fitness_history))
        mins = np.asarray([np.min(f) for f in fitness_history])
        means = np.asarray([np.mean(f) for f in fitness_history])
        maxs = np.asarray([np.max(f) for f in fitness_history])
        fig = go.Figure(
            [
                go.Scatter(x=gens, y=mins, mode="lines", name="min"),
                go.Scatter(x=gens, y=means, mode="lines", name="mean"),
                go.Scatter(x=gens, y=maxs, mode="lines", name="max"),
            ],
            layout=go.Layout(
                xaxis={"title": "Generation"}, yaxis={"title": "Fitness"}, **kwargs
            ),
        )
        return fig
    frames = [[go.Histogram(x=f)] for f in fitness_history]
    all_fit = np.concatenate(fitness_history)
    return _animated_scatter(
        frames, dict(xaxis={"range": _padded_range(all_fit)}, **kwargs)
    )


def plot_obj_space_1d_no_animation(fitness_history: List[np.ndarray], **kwargs):
    """Static min/mean/max fitness curves."""
    return plot_obj_space_1d(fitness_history, animation=False, **kwargs)


def plot_obj_space_1d_animation(fitness_history: List[np.ndarray], **kwargs):
    """Animated per-generation fitness histogram."""
    return plot_obj_space_1d(fitness_history, animation=True, **kwargs)


def _generation_colored_overlay(fitness_history, pf_trace, scatter_cls, dims):
    """Static multi-objective figure: every generation's points in one
    scatter, colored by generation index (sequential colorscale), the true
    Pareto front overlaid — the no-animation view of a converging front."""
    counts = [len(f) for f in fitness_history]
    gen_idx = np.repeat(np.arange(len(fitness_history)), counts)
    all_fit = np.concatenate(fitness_history, axis=0)
    coords = {ax: all_fit[:, i] for i, ax in enumerate(dims)}
    traces = pf_trace + [
        scatter_cls(
            mode="markers",
            marker={
                "color": gen_idx,
                "colorscale": "Viridis",
                "size": 2 if len(dims) == 3 else 4,
                "colorbar": {"title": "Generation"},
            },
            name="population",
            **coords,
        )
    ]
    return traces


def plot_obj_space_2d(
    fitness_history: List[np.ndarray],
    problem_pf: np.ndarray | None = None,
    sort_points: bool = False,
    animation: bool = True,
    **kwargs,
):
    """2-objective scatter with optional true Pareto front overlay:
    animated per-generation frames, or — with ``animation=False`` — one
    static figure of every generation's points colored by generation
    index."""
    go = _go()
    fitness_history = [_host(f) for f in fitness_history]
    if sort_points:
        fitness_history = [f[np.argsort(f[:, 0])] for f in fitness_history]
    pf_trace = []
    if problem_pf is not None:
        problem_pf = _host(problem_pf)
        pf_trace = [
            go.Scatter(
                x=problem_pf[:, 0],
                y=problem_pf[:, 1],
                mode="markers",
                marker={"color": "#FFA15A", "size": 3},
                name="Pareto front",
            )
        ]
    all_fit = np.concatenate(fitness_history, axis=0)
    layout = dict(
        xaxis={"range": _padded_range(all_fit[:, 0])},
        yaxis={"range": _padded_range(all_fit[:, 1])},
        **kwargs,
    )
    if not animation:
        traces = _generation_colored_overlay(
            fitness_history, pf_trace, go.Scatter, ("x", "y")
        )
        return go.Figure(data=traces, layout=go.Layout(**layout))
    frames = [
        pf_trace
        + [
            go.Scatter(
                x=f[:, 0], y=f[:, 1], mode="markers", marker={"color": "#636EFA"}
            )
        ]
        for f in fitness_history
    ]
    return _animated_scatter(frames, layout)


def plot_obj_space_3d(
    fitness_history: List[np.ndarray],
    problem_pf: np.ndarray | None = None,
    sort_points: bool = False,
    animation: bool = True,
    **kwargs,
):
    """3-objective scatter with optional true Pareto front overlay:
    animated per-generation frames, or — with ``animation=False`` — one
    static figure of every generation's points colored by generation
    index."""
    go = _go()
    fitness_history = [_host(f) for f in fitness_history]
    if sort_points:
        fitness_history = [f[np.argsort(f[:, 0])] for f in fitness_history]
    pf_trace = []
    if problem_pf is not None:
        problem_pf = _host(problem_pf)
        pf_trace = [
            go.Scatter3d(
                x=problem_pf[:, 0],
                y=problem_pf[:, 1],
                z=problem_pf[:, 2],
                mode="markers",
                marker={"color": "#FFA15A", "size": 2},
                name="Pareto front",
            )
        ]
    # Fixed scene ranges from the full history (like the 2D paths): frames
    # of an animation must not rescale, and the static figure should frame
    # identically to its animated counterpart.
    all_fit = np.concatenate(fitness_history, axis=0)
    scene = {
        axis: {"range": _padded_range(all_fit[:, i])}
        for i, axis in enumerate(("xaxis", "yaxis", "zaxis"))
    }
    scene.update(kwargs.pop("scene", {}))  # caller's scene opts (camera, ...) win
    layout = dict(scene=scene, **kwargs)
    if not animation:
        traces = _generation_colored_overlay(
            fitness_history, pf_trace, go.Scatter3d, ("x", "y", "z")
        )
        return go.Figure(data=traces, layout=go.Layout(**layout))
    frames = [
        pf_trace
        + [
            go.Scatter3d(
                x=f[:, 0],
                y=f[:, 1],
                z=f[:, 2],
                mode="markers",
                marker={"color": "#636EFA", "size": 2},
            )
        ]
        for f in fitness_history
    ]
    return _animated_scatter(frames, layout)
