"""The port's vendored engines and their adapters
(``evox_tpu_torch.problems.neuroevolution``: ``minibrax``,
``miniplayground``, ``BraxProblem``, ``MujocoProblem``) against the JAX
package's, on the CPU.

``BraxProblem``/``MujocoProblem`` import ``brax``/``mujoco_playground``
when they are built.  The JAX package's own tests alias its JAX engines
under those names for the rest of their process
(``tests/test_brax_integration.py``), so these tests never call
``activate()`` for real: each installs the engine it needs under every
name the adapter imports with ``monkeypatch.setitem``, which puts
``sys.modules`` back as it found it after the test.

Tolerances: the planar physics is elementwise and was measured equal to
JAX's bit for bit (Hopper, with 4 substeps and its link force scattered
by ``index_add``); PointMass's distance is a 2-entry norm, within
:data:`STEP_RTOL`.  Rollout returns through the adapters (MLP products
summed in another order feed back into the dynamics) within
:data:`RETURN_RTOL`, the hopper's within :data:`HOPPER_RETURN_RTOL`, for
the individuals whose JAX trajectory stays :data:`EDGE_MARGIN` away from
the termination threshold.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.problems import neuroevolution as jne  # noqa: E402
from evox_tpu.problems.neuroevolution import minibrax as jmb  # noqa: E402
from evox_tpu.problems.neuroevolution import miniplayground as jmp  # noqa: E402
from evox_tpu_torch.problems import neuroevolution as tne  # noqa: E402
from evox_tpu_torch.problems.neuroevolution import minibrax as tmb  # noqa: E402
from evox_tpu_torch.problems.neuroevolution import miniplayground as tmp  # noqa: E402
from evox_tpu_torch.problems.neuroevolution.utils import alias_vendored  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402
from evox_tpu_torch.utils.convert import params_from_numpy  # noqa: E402
from test_torch_neuroevolution import Injected, jax_margin, jax_params, rel, to_torch  # noqa: E402

CPU = torch.device("cpu")
STEP_RTOL = 1e-6
RETURN_RTOL = 1e-4
# The hopper's stiff ground contact amplifies last-bit differences over 40
# steps: JAX's own jitted and eager evaluations of one rollout (8
# individuals, 2 episodes) differ by 3.5e-4, the port and jitted JAX by
# 5.5e-4.
HOPPER_RETURN_RTOL = 2e-3
EDGE_MARGIN = 1e-4
BRAX_NAMES = ("brax", "brax.envs", "brax.io", "brax.io.html", "brax.io.image")
PLAYGROUND_NAMES = ("mujoco_playground", "mujoco_playground.registry")


def install(mp, engine):
    """Install ``engine`` (a minibrax or miniplayground package, either
    framework's) under the names its adapter imports."""
    if hasattr(engine, "envs"):
        mods = (engine, engine.envs, engine.io, engine.io.html, engine.io.image)
        names = BRAX_NAMES
    else:
        mods, names = (engine, engine.registry), PLAYGROUND_NAMES
    for name, mod in zip(names, mods):
        mp.setitem(sys.modules, name, mod)


def _brax_state(js):
    """A JAX minibrax ``State`` (any leading axes) as the port's."""
    ps = tmb.PipelineState(*(torch.from_numpy(np.array(x)) for x in js.pipeline_state))
    return tmb.envs.State(ps, *(torch.from_numpy(np.array(x)) for x in (js.obs, js.reward, js.done)))


def _playground_state(js):
    ps = tmb.PipelineState(*(torch.from_numpy(np.array(x)) for x in js.data))
    return tmp.State(ps, to_torch(js.obs), *(torch.from_numpy(np.array(x)) for x in (js.reward, js.done)))


# ---------------------------------------------------------------------------
# minibrax physics and environments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["hopper", "pointmass"])
def test_minibrax_env_steps_match_jax(name, recwarn):
    """25 steps of 8 episodes from JAX's resets under the same actions
    (beyond the clip bounds), through ``torch.func.vmap`` with no
    functorch fallback: positions, velocities, observations and rewards,
    ``done`` exactly."""
    jenv = jmb.envs.get_environment(env_name=name)
    tenv = tmb.envs.get_environment(env_name=name, device=CPU)
    assert (tenv.observation_size, tenv.action_size, tenv.dt) == (jenv.observation_size, jenv.action_size, jenv.dt)
    js = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(3), 8))
    ts = _brax_state(js)
    r = np.random.default_rng(0)
    jstep, tstep = jax.vmap(jenv.step), torch.func.vmap(tenv.step)
    worst = 0.0
    with jax.disable_jit():
        for _ in range(25):
            a = r.uniform(-1.5, 1.5, (8, jenv.action_size)).astype(np.float32)
            js, ts = jstep(js, jnp.asarray(a)), tstep(ts, torch.from_numpy(a))
            pairs = [(ts.pipeline_state.q, js.pipeline_state.q), (ts.pipeline_state.qd, js.pipeline_state.qd),
                     (ts.obs, js.obs), (ts.reward, js.reward)]
            for got, want in pairs:
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32
                worst = max(worst, rel(got, want))
            np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    assert worst <= (0.0 if name == "hopper" else STEP_RTOL)
    assert not [w for w in recwarn if "performance drop" in str(w.message)]


@pytest.mark.parametrize("name", ["hopper", "pointmass"])
def test_minibrax_reset_and_batch_shaped_step(name):
    env = tmb.envs.get_environment(env_name=name, device=CPU)
    keys = torch.stack(rng.split_keys(rng.key(1), 6))
    s = torch.func.vmap(env.reset)(keys)
    assert s.obs.shape == (6, env.observation_size) and not s.done.any() and not s.reward.any()
    if name == "hopper":
        q = s.pipeline_state.q
        assert bool((q[:, :, 0] == 0).all()) and bool(((q[:, 0, 1] - 0.75).abs() <= 0.05).all())
    a = torch.linspace(-1, 1, 6 * env.action_size).reshape(6, env.action_size)
    vm = torch.func.vmap(env.step)(s, a)
    batch = env.step(s, a)  # no vmap: (6, ...) state tensors
    for got, want in zip(torch.utils._pytree.tree_leaves(batch), torch.utils._pytree.tree_leaves(vm)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_pipeline_step_with_zero_links_matches_jax_under_vmap():
    """PointMass's system has no link (``link_idx`` of shape (0, 2)): the
    generic pipeline step scatters nothing, also under vmap."""
    jsys, tsys = jmb.envs.PointMass().sys, tmb.envs.PointMass(device=CPU).sys
    assert tuple(tsys.link_idx.shape) == (0, 2)
    r = np.random.default_rng(4)
    q, qd = (r.uniform(-1, 1, (5, 1, 2)).astype(np.float32) for _ in range(2))
    q[:, :, 1] = r.uniform(-0.05, 0.3, (5, 1)).astype(np.float32)  # some below the radius: contact
    act = r.uniform(-1, 1, 5).astype(np.float32)
    with jax.disable_jit():
        want = jax.vmap(lambda q, qd, a: jmb.pipeline_step(jsys, jmb.PipelineState(q, qd), a))(q, qd, act)
    got = torch.func.vmap(lambda q, qd, a: tmb.pipeline_step(tsys, tmb.PipelineState(q, qd), a))(
        *(torch.from_numpy(x) for x in (q, qd, act)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.qd.numpy(), np.asarray(want.qd))


def test_hopper_physics_is_real():
    """Gravity pulls the torso down without thrust, ground contact holds the
    foot, and thrust changes the trajectory (the JAX package's sanity
    check)."""
    env = tmb.envs.get_environment(env_name="hopper", device=CPU)
    s = env.reset(rng.key(0))
    passive = driven = s
    for i in range(50):
        passive = env.step(passive, torch.zeros(1))
        driven = env.step(driven, torch.ones(1) * (1.0 if i % 10 < 5 else -1.0))
    assert float(passive.pipeline_state.q[1, 1]) > -0.05
    assert not torch.allclose(driven.pipeline_state.q, passive.pipeline_state.q)


def test_get_environment_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown minibrax env"):
        tmb.envs.get_environment(env_name="ant", device=CPU)
    with pytest.raises(ValueError, match="unknown miniplayground env"):
        tmp.registry.load("Ant", device=CPU)


@pytest.mark.parametrize("renderer", ["html", "image"])
def test_renderers_match_jax_on_one_trajectory(renderer):
    """The renderers are numpy on both sides: the same trajectory gives the
    same document and the same frames."""
    jenv = jmb.envs.get_environment(env_name="hopper")
    tsys = tmb.envs.get_environment(env_name="hopper", device=CPU).sys
    s = jenv.reset(jax.random.key(0))
    traj = [s.pipeline_state]
    for i in range(6):
        s = jenv.step(s, jnp.full((1,), 0.5 if i % 2 else -0.5))
        traj.append(s.pipeline_state)
    ttraj = [tmb.PipelineState(torch.from_numpy(np.array(p.q)), torch.from_numpy(np.array(p.qd))) for p in traj]
    if renderer == "html":
        assert tmb.io.html.render(tsys, ttraj) == jmb.io.html.render(jenv.sys, traj)
    else:
        np.testing.assert_array_equal(tmb.io.image.render_array(tsys, ttraj, 48, 64),
                                      jmb.io.image.render_array(jenv.sys, traj, 48, 64))


# ---------------------------------------------------------------------------
# miniplayground
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Hopper", "PointMass"])
def test_miniplayground_dict_obs_match_jax(name):
    jenv, tenv = jmp.registry.load(name), tmp.registry.load(name, device=CPU)
    assert tenv.observation_size == jenv.observation_size
    assert isinstance(tenv.observation_size, dict) and tenv.observation_size["privileged"] == 3
    assert tmp.registry.ALL_ENVS == jmp.registry.ALL_ENVS
    js = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(5), 4))
    ts = _playground_state(js)
    r = np.random.default_rng(1)
    with jax.disable_jit():
        for _ in range(10):
            a = r.uniform(-1, 1, (4, jenv.action_size)).astype(np.float32)
            js, ts = jax.vmap(jenv.step)(js, jnp.asarray(a)), torch.func.vmap(tenv.step)(ts, torch.from_numpy(a))
            assert sorted(ts.obs) == ["privileged", "state"]
            for k in ts.obs:
                assert rel(ts.obs[k], js.obs[k]) <= STEP_RTOL
            np.testing.assert_array_equal(ts.obs["privileged"][:, 1].numpy(), ts.done.numpy())
            assert not ts.obs["privileged"][:, 2].any()
    frames = tenv.render([ts.data.__class__(ts.data.q[0], ts.data.qd[0])], height=16, width=24)
    assert len(frames) == 1 and frames[0].shape == (16, 24, 3) and frames[0].dtype == np.uint8


# ---------------------------------------------------------------------------
# The adapters
# ---------------------------------------------------------------------------


class InjectedBrax(Injected, tne.BraxProblem):
    pass


class InjectedMujoco(Injected, tne.MujocoProblem):
    pass


ADAPTERS = {
    # name: (JAX adapter, port adapter, engines, env, state converter,
    #        termination distance along JAX's trajectory)
    "brax_hopper": (jne.BraxProblem, InjectedBrax, (jmb, tmb), "hopper", _brax_state,
                    lambda s: jnp.abs(s.pipeline_state.q[..., 0, 1] - 0.35)),
    "brax_pointmass": (jne.BraxProblem, InjectedBrax, (jmb, tmb), "pointmass", _brax_state,
                       lambda s: jnp.abs(jnp.linalg.norm(s.pipeline_state.q[..., 0, :], axis=-1) - 4.0)),
    "mujoco_hopper": (jne.MujocoProblem, InjectedMujoco, (jmp, tmp), "Hopper", _playground_state,
                      lambda s: jnp.abs(s.data.q[..., 0, 1] - 0.35)),
    "mujoco_pointmass": (jne.MujocoProblem, InjectedMujoco, (jmp, tmp), "PointMass", _playground_state,
                         lambda s: jnp.abs(jnp.linalg.norm(s.data.q[..., 0, :], axis=-1) - 4.0)),
}


@pytest.mark.parametrize("case", list(ADAPTERS))
def test_adapter_returns_match_jax(case, monkeypatch):
    """The adapter over the port's engine against the JAX adapter over the
    JAX engine: 8 individuals, 2 episodes, 40 steps, from JAX's initial
    states; sizes from the environment; returns within RETURN_RTOL."""
    jcls, tcls, (jengine, tengine), env_name, convert, edge = ADAPTERS[case]
    install(monkeypatch, jengine)
    jprob = jcls(None, env_name, max_episode_length=40, num_episodes=2)
    install(monkeypatch, tengine)
    tprob = tcls(None, env_name, max_episode_length=40, num_episodes=2, device=CPU)
    assert (tprob.env.obs_size, tprob.env.action_size) == (jprob.env.obs_size, jprob.env.action_size)
    sizes = (jprob.env.obs_size, 8, jprob.env.action_size)
    jprob.policy = jne.MLPPolicy(sizes).apply
    tprob.policy = tne.MLPPolicy(sizes).apply
    params = jax_params(sizes, seed=2, pop=8)
    jkey = jax.random.key(6)
    want, _ = jax.jit(jprob.evaluate)(jprob.setup(jkey), params)
    eval_key = jax.random.split(jkey)[1]
    s0, obs0 = jax.vmap(jprob.env.reset)(jax.random.split(eval_key, 2))
    tprob.next_resets = (convert(s0), torch.from_numpy(np.array(obs0)))
    got, _ = tprob.evaluate(tprob.setup(rng.key(6)), params_from_numpy(params, CPU))
    margin = jax_margin(jprob.policy, jprob.env.step, params, s0, obs0, 40, edge)
    clear = (margin >= EDGE_MARGIN).all(axis=1)
    assert clear.sum() >= 6, margin
    limit = HOPPER_RETURN_RTOL if "hopper" in case else RETURN_RTOL
    assert rel(got.numpy()[clear], np.asarray(want)[clear]) <= limit
    assert len(np.unique(got.numpy())) > 1


def test_adapters_leave_sys_modules_as_they_found_them():
    names = BRAX_NAMES + PLAYGROUND_NAMES
    before = {n: sys.modules.get(n) for n in names}
    with pytest.MonkeyPatch.context() as mp:
        install(mp, tmb)
        install(mp, tmp)
        assert tne.BraxProblem(None, "hopper", 5, device=CPU).env.obs_size == 5
        assert tne.MujocoProblem(None, "PointMass", 5, device=CPU).env.obs_size == 4
    assert {n: sys.modules.get(n) for n in names} == before


@pytest.mark.parametrize("engine", ["brax", "playground"])
def test_adapters_refuse_a_jax_engine(engine, monkeypatch):
    """A JAX engine (here the JAX package's vendored one, standing for the
    real brax or MJX) is refused with a clear error."""
    if engine == "brax":
        install(monkeypatch, jmb)
        with pytest.raises(TypeError, match="torch tensors"):
            tne.BraxProblem(None, "hopper", 5, device=CPU)
    else:
        install(monkeypatch, jmp)
        with pytest.raises(TypeError, match="torch tensors"):
            tne.MujocoProblem(None, "Hopper", 5, device=CPU)


@pytest.mark.parametrize("engine", ["brax", "playground"])
def test_adapters_let_an_engines_own_errors_through(engine, monkeypatch):
    """A fault inside a torch engine's reset reaches the caller as it is,
    not as the foreign-engine TypeError."""
    class Broken:
        def reset(self, key):
            raise RuntimeError("a fault in the engine's reset")

    if engine == "brax":
        install(monkeypatch, tmb)
        monkeypatch.setattr(tmb.envs, "get_environment", lambda **kw: Broken())
        with pytest.raises(RuntimeError, match="fault in the engine"):
            tne.BraxProblem(None, "hopper", 5, device=CPU)
    else:
        install(monkeypatch, tmp)
        monkeypatch.setattr(tmp.registry, "load", lambda name, device=None: Broken())
        with pytest.raises(RuntimeError, match="fault in the engine"):
            tne.MujocoProblem(None, "PointMass", 5, device=CPU)


@pytest.mark.parametrize("adapter,name", [("BraxProblem", "brax"), ("MujocoProblem", "mujoco_playground")])
def test_adapters_without_an_engine_raise_import_error(adapter, name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, None)  # import of `name` fails
    with pytest.raises(ImportError, match="vendored"):
        getattr(tne, adapter)(None, "hopper", 5, device=CPU)


def test_activate_aliases_only_an_absent_package(monkeypatch):
    # Absent: the vendored package answers under every name.
    for name in BRAX_NAMES + PLAYGROUND_NAMES:
        monkeypatch.setitem(sys.modules, name, None)
    assert tmb.activate() is tmb and tmp.activate() is tmp
    import brax.io.html
    from mujoco_playground import registry

    assert sys.modules["brax.envs"] is tmb.envs and brax.io.html is tmb.io.html and registry is tmp.registry
    # Present: returned untouched.
    monkeypatch.setitem(sys.modules, "brax", jmb)
    assert tmb.activate() is jmb
    import json

    assert alias_vendored("json", tmb) is json


def test_brax_problem_evaluates_and_vmaps_over_instances(monkeypatch):
    """The adapter under an extra vmap level (problem instances, as HPO
    stacks them) equals each instance's solo evaluation bit for bit."""
    install(monkeypatch, tmb)
    prob = tne.BraxProblem(None, "pointmass", max_episode_length=8, device=CPU)
    policy = tne.MLPPolicy((4, 8, 2))
    prob.policy = policy.apply
    pop = tne.stack_model_params(policy.init, rng.key(1), 6)
    fit, _ = prob.evaluate(prob.setup(rng.key(2)), pop)
    assert fit.shape == (6,) and bool(torch.isfinite(fit).all()) and len(torch.unique(fit)) > 1
    pop2 = {k: v.reshape((2, 3) + v.shape[1:]) for k, v in pop.items()}
    keys = torch.stack(rng.split_keys(rng.key(5), 2))
    fit2, _ = torch.func.vmap(prob.evaluate)(torch.func.vmap(prob.setup)(keys), pop2)
    for i in range(2):
        solo, _ = prob.evaluate(prob.setup(keys[i]), {k: v[i] for k, v in pop2.items()})
        torch.testing.assert_close(fit2[i], solo, rtol=0, atol=0)


def test_brax_visualize_both_outputs(monkeypatch):
    install(monkeypatch, tmb)
    prob = tne.BraxProblem(None, "hopper", max_episode_length=10, device=CPU)
    policy = tne.MLPPolicy((5, 8, 1))
    prob.policy = policy.apply
    params = policy.init(rng.key(1))
    html = prob.visualize(prob.setup(rng.key(0)), params)
    assert isinstance(html, str) and "<html" in html.lower() and '"frames"' in html
    frames = prob.visualize(prob.setup(rng.key(0)), params, output_type="rgb_array")
    assert frames.ndim == 4 and frames.shape[3] == 3 and frames.shape[0] >= 2 and frames.dtype == np.uint8
    assert len(np.unique(frames.reshape(-1, 3), axis=0)) >= 3
    with pytest.raises(ValueError):
        prob.visualize(prob.setup(rng.key(0)), params, output_type="mp4")


def test_mujoco_visualize_writes_gif(monkeypatch, tmp_path):
    pytest.importorskip("imageio")
    install(monkeypatch, tmp)
    prob = tne.MujocoProblem(None, "PointMass", max_episode_length=8, device=CPU)
    policy = tne.MLPPolicy((4, 8, 2))
    prob.policy = policy.apply
    rendered = []
    render = prob._mjx_env.render
    monkeypatch.setattr(prob._mjx_env, "render", lambda traj, **kw: rendered.append(len(traj)) or render(traj, **kw))
    out = prob.visualize(prob.setup(rng.key(0)), policy.init(rng.key(1)), seed=3, output_type="gif",
                         output_path=str(tmp_path / "rollout"), height=48, width=64)
    assert out.endswith(".gif") and os.path.getsize(out) > 0
    assert rendered == [9]  # the reset frame + 8 steps
