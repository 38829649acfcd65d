"""``rollingdepth_torch.training`` against ``rollingdepth_tpu.training`` on
the tiny UNet, fp32 on the CPU: same weights (``state_dict_from_jax``),
same batches made with numpy, and JAX's timestep and noise draws passed to
the port's step.

Tolerances: the schedule within 1e-6 of the peak rate (optax computes it
in fp32), an optimizer update on identical gradients within 1e-6; loss
rtol 1e-5 and each parameter's gradient within 1e-5 of its largest
|value| (fp32 sums in another order through the UNet and its backward);
``grad_norm`` rtol 1e-4; parameters after Adam updates within 1e-6 + 2.2
lr (the first Adam update is lr * sign(g), so a gradient near 0 may take
the other sign in the two packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rollingdepth_torch.io.weights import adamw_state_from_jax, state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.schedulers.ddim import DDIMConfig, DDIMScheduler
from rollingdepth_torch.training import (
    TrainConfig, apply_gradients, make_lr_schedule, make_optimizer, make_train_step, optimizer_step,
    restore_train_state, save_train_state, training_loss,
)
from rollingdepth_tpu import training as jt
from rollingdepth_tpu.models.unet import UNet2DCondition, unet_apply
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler

torch.set_num_threads(2)

SCHED = dict(beta_schedule="scaled_linear", prediction_type="v_prediction", timestep_spacing="trailing")
SCHEDULES = [
    TrainConfig(),
    TrainConfig(warmup_steps=4),
    TrainConfig(lr_schedule="cosine", warmup_steps=3, total_steps=12),
    TrainConfig(lr_schedule="cosine", warmup_steps=0, total_steps=9),
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=["constant", "warmup", "cosine", "cosine_no_warmup"])
def test_lr_schedule_matches_optax(cfg):
    ref = jt.make_lr_schedule(jt.TrainConfig(**dataclasses.asdict(cfg)))
    got = make_lr_schedule(cfg)
    for step in range(16):
        want = float(ref(step)) if callable(ref) else ref
        # optax computes in fp32: agreement to fp32 rounding at the peak's scale
        assert got(step) == pytest.approx(want, rel=1e-6, abs=1e-6 * cfg.learning_rate), step
    assert got(0) == (cfg.learning_rate if cfg.warmup_steps == 0 and cfg.lr_schedule == "constant" else 0.0)


def test_lr_schedule_refuses_unknown():
    with pytest.raises(ValueError):
        make_lr_schedule(TrainConfig(lr_schedule="step"))
    with pytest.raises(ValueError):
        make_lr_schedule(TrainConfig(lr_schedule="cosine", warmup_steps=5, total_steps=5))


@pytest.mark.parametrize("grad_scale", [5.0, 0.05], ids=["clipped", "below_clip"])
def test_optimizer_update_matches_optax(grad_scale):
    """Three updates on identical gradients: AdamW behind the clip against
    ``optax.chain(clip_by_global_norm, adamw)`` with its schedule."""
    cfg = TrainConfig(learning_rate=1e-2, weight_decay=0.1, lr_schedule="cosine", warmup_steps=1, total_steps=6)
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    opt = jt.make_optimizer(jt.TrainConfig(**dataclasses.asdict(cfg)))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = make_optimizer(params.values(), cfg)
    schedule = make_lr_schedule(cfg)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm, _ = apply_gradients(topt, list(params.values()), cfg, schedule)
        want_norm = float(optax.global_norm(g))
        assert (want_norm > cfg.grad_clip) == (grad_scale > 1)
        assert float(norm) == pytest.approx(want_norm, rel=1e-6)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert optimizer_step(topt) == 3


@pytest.mark.parametrize("t_shape", [(3,), (3, 2)])
def test_velocity_and_add_noise_match_jax(t_shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = rng.integers(0, 1000, t_shape)
    js, ts = JDDIMScheduler(JDDIMConfig(**SCHED)), DDIMScheduler(DDIMConfig(**SCHED))
    for name in ("add_noise", "get_velocity"):
        want = np.asarray(getattr(js, name)(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)))
        got = getattr(ts, name)(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    half = ts.get_velocity(torch.from_numpy(x).bfloat16(), torch.from_numpy(noise), torch.from_numpy(t))
    assert half.dtype == torch.bfloat16


# ---- the step against JAX's


def _tiny_pair(seed=0):
    jcfg = JUNetConfig.tiny(in_channels=8)
    params = UNet2DCondition(jcfg).init(jax.random.PRNGKey(seed))
    unet = UNet2DConditionModel(UNetConfig.tiny(in_channels=8), device="cpu")
    unet.load_state_dict(state_dict_from_jax(params))
    return jcfg, params, unet


def _batch(seed, b=2, n=3, hw=(8, 8)):
    rng = np.random.default_rng(seed)
    lat = lambda: rng.standard_normal((b, n) + hw + (4,)).astype(np.float32)  # noqa: E731
    return {"rgb_latent": lat(), "depth_latent": lat(), "text_embed": rng.standard_normal((1, 2, 8)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_draws(key, batch):
    """The draws of JAX's loss_fn for ``key``: t [B] and noise."""
    k_t, k_noise = jax.random.split(key)
    dep = batch["depth_latent"]
    t = jax.random.randint(k_t, (dep.shape[0],), 0, 1000)
    noise = jax.random.normal(k_noise, dep.shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _close_params(unet, jparams, lr, what):
    want = state_dict_from_jax(jparams)
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6 + 2.2 * lr,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_loss_and_gradients_match_jax(prediction_type):
    """JAX's loss_fn, written out with the JAX package's functions, through
    ``jax.value_and_grad``; the port's ``training_loss`` through autograd."""
    jcfg, params, unet = _tiny_pair()
    batch = _batch(2)
    js, ts = JDDIMScheduler(JDDIMConfig(**SCHED)), DDIMScheduler(DDIMConfig(**SCHED))
    t, noise = _jax_draws(jax.random.PRNGKey(3), batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtt, jn = jnp.asarray(t.numpy()), jnp.asarray(noise.numpy())

    def loss_fn(p):
        dep = jb["depth_latent"]
        t_frames = jtt[:, None].repeat(dep.shape[1], 1)
        noisy = js.add_noise(dep, jn, t_frames).astype(dep.dtype)
        pred = unet_apply(p, jcfg, jnp.concatenate([jb["rgb_latent"], noisy], axis=-1), jtt, jb["text_embed"])
        target = jn if prediction_type == "epsilon" else js.get_velocity(dep, jn, t_frames)
        return jnp.mean((pred.astype(jnp.float32) - target) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    loss = training_loss(unet, ts, prediction_type, _torch_batch(batch), t, noise)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = state_dict_from_jax(want_grads)
    for name, p in unet.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=name)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's jitted train step, three steps from the tiny init, per config."""
    runs = {}

    def run(cfg, steps=3):
        key = (cfg, steps)
        if key not in runs:
            jcfg, params, _ = _tiny_pair()
            jtcfg = jt.TrainConfig(**dataclasses.asdict(cfg))
            step = jax.jit(jt.make_train_step(jcfg, JDDIMScheduler(JDDIMConfig(**SCHED)), jtcfg))
            state = jt.init_train_state(params, jtcfg)
            states, metrics = [state], []
            for i in range(steps):
                state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(10 + i).items()},
                                jax.random.PRNGKey(i))
                states.append(state)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[key] = states, metrics
        return runs[key]

    return run


TRAIN_CONFIGS = [
    TrainConfig(learning_rate=1e-3, prediction_type="v_prediction"),
    TrainConfig(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=1, total_steps=10),
]


@pytest.mark.parametrize("cfg", TRAIN_CONFIGS, ids=["constant_v", "cosine_eps"])
def test_train_steps_match_jax(jax_run, cfg):
    """Three steps: loss and grad_norm at each, the parameters after."""
    states, metrics = jax_run(cfg)
    _, _, unet = _tiny_pair()
    step = make_train_step(unet, DDIMScheduler(DDIMConfig(**SCHED)), cfg)
    schedule = make_lr_schedule(cfg)
    for i, want in enumerate(metrics):
        batch = _batch(10 + i)
        t, noise = _jax_draws(jax.random.PRNGKey(i), batch)
        m = step(_torch_batch(batch), timesteps=t, noise=noise)
        assert m["lr"] == pytest.approx(schedule(i))
        assert m["loss"].item() == pytest.approx(want["loss"], rel=1e-5), i
        assert m["grad_norm"].item() == pytest.approx(want["grad_norm"], rel=1e-4), i
    assert optimizer_step(step.optimizer) == int(states[-1].step) == 3
    _close_params(unet, states[-1].params, cfg.learning_rate, "after 3 steps")


def test_resume_from_jax_optimizer_state(jax_run):
    """Two JAX steps, then the third in the port from JAX's parameters and
    Adam moments (``adamw_state_from_jax``)."""
    cfg = TRAIN_CONFIGS[0]
    states, metrics = jax_run(cfg)
    _, _, unet = _tiny_pair()
    unet.load_state_dict(state_dict_from_jax(states[2].params))
    step = make_train_step(unet, DDIMScheduler(DDIMConfig(**SCHED)), cfg)
    step.optimizer.state.update(adamw_state_from_jax(jax.device_get(states[2].opt_state), unet))
    assert optimizer_step(step.optimizer) == 2
    batch = _batch(12)
    t, noise = _jax_draws(jax.random.PRNGKey(2), batch)
    m = step(_torch_batch(batch), timesteps=t, noise=noise)
    assert m["loss"].item() == pytest.approx(metrics[2]["loss"], rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(metrics[2]["grad_norm"], rel=1e-4)
    _close_params(unet, states[3].params, cfg.learning_rate, "resumed step")


def test_adamw_state_from_jax_layouts():
    """Moments take the parameters' names, layouts (conv OIHW, linear
    [O, I], the fused GEGLU projection) and devices."""
    _, params, unet = _tiny_pair()
    state = optax.adamw(1e-3).init(params)
    state = jax.tree_util.tree_map(lambda x: x, state)
    mu = jax.tree_util.tree_map(lambda x: np.full(x.shape, 2.0, np.float32), params)
    nu = jax.tree_util.tree_map(lambda x: np.full(x.shape, 3.0, np.float32), params)
    adam = state[0]._replace(count=np.int32(5), mu=mu, nu=nu)
    out = adamw_state_from_jax((optax.EmptyState(), (adam,) + tuple(state[1:])), unet)
    for name, p in unet.named_parameters():
        st = out[p]
        assert st["exp_avg"].shape == p.shape and torch.all(st["exp_avg"] == 2.0), name
        assert torch.all(st["exp_avg_sq"] == 3.0) and st["step"].item() == 5.0
    with pytest.raises(ValueError):
        adamw_state_from_jax((optax.EmptyState(),), unet)


def test_checkpoint_round_trip_is_bit_identical(tmp_path):
    """Two steps, save; a third step in place and a third after restoring
    into a fresh model and optimizer give bit-identical parameters."""
    cfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine", warmup_steps=1, total_steps=10)
    sched = DDIMScheduler(DDIMConfig(**SCHED))
    _, _, unet = _tiny_pair()
    step = make_train_step(unet, sched, cfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        step(_torch_batch(_batch(20 + i)), gen)
    path = tmp_path / "state.pt"
    save_train_state(str(path), unet, step.optimizer)
    assert [p.name for p in tmp_path.iterdir()] == ["state.pt"]  # no temporary file left

    gen_state = gen.get_state()
    last = _torch_batch(_batch(22))
    m_a = step(last, gen)
    _, _, fresh = _tiny_pair(seed=1)
    step_b = make_train_step(fresh, sched, cfg)
    assert restore_train_state(str(path), fresh, step_b.optimizer) == 2
    m_b = step_b(last, torch.Generator().set_state(gen_state))
    assert torch.equal(m_a["loss"], m_b["loss"]) and torch.equal(m_a["grad_norm"], m_b["grad_norm"])
    for (name, a), b in zip(unet.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(step.optimizer.state.values(), step_b.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_train_step_refuses_unknown_target():
    _, _, unet = _tiny_pair()
    with pytest.raises(ValueError):
        make_train_step(unet, DDIMScheduler(), TrainConfig(prediction_type="sample"))
