"""``rollingdepth_torch/parallel`` against the JAX package's sharding, on the CPU.

Four gloo ranks (``parallel/launch.py``, one thread each, 60 s per
collective, 240 s in all) run the port's sharded paths once for the whole
module as a (dp, tp) = (2, 2) mesh (``tests/torch_parallel_ranks.py``),
while this process computes the JAX references; each test then holds its
part of the ranks' results.

Tolerances:
- the split dimension of every UNet parameter equals JAX's
  ``PartitionSpec`` exactly, except the attention of blocks whose heads tp
  does not divide, which the port keeps whole;
- f and g against the unsharded MLP: 1e-6 (fp32 sums of two halves);
  ``torch.distributed.nn.functional.all_reduce`` as g gives tp times the
  gradient, which the same check refuses;
- the tp = 2 UNet against JAX's unsharded ``unet_apply``: 2e-5, the JAX
  test's (``tests/test_parallel.py``);
- the dp x tp depth pipeline: windows' latents within 1e-5 of JAX's
  (``tests/test_pipeline_sharded.py``), decoded windows within 1e-5 and the
  depth at one solve iteration within 1e-4 (the fast path,
  ``tests/test_torch_pipeline.py``) or 2e-4 (refine and the depth-space
  merge, ``tests/test_torch_refine.py``) of JAX's; against the unsharded
  port (run on one thread, as each rank) after the full 2000-iteration
  solve within 5e-3 (``test_pipeline_sharded.py``);
- the dp x tp relight windows and R/G/B against the unsharded port: 1e-5
  of their scale;
- the dp x tp W8A8 UNet: bit for bit against the unsharded quantized port,
  and JAX's quantized-UNet bounds (correlation above 0.99, rms below 0.1)
  against JAX's sharded W8A8 (the test says why no tighter);
- the dp x tp train step against JAX's: loss rtol 1e-5, grad_norm rtol
  1e-4 (``tests/test_parallel.py``), every parameter element within
  1e-6 + 2.2 lr (``tests/test_torch_training.py``) and each parameter's
  mean |difference| within 1e-6, which a shard whose update is skipped
  exceeds; a restored checkpoint steps bit for bit as the model it was
  saved from.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parallel_ranks as R
from rollingdepth_torch.io.weights import state_dict_from_jax
from rollingdepth_torch.models.unet import UNet2DConditionModel, UNetConfig
from rollingdepth_torch.parallel.launch import start_ranks
from rollingdepth_torch.parallel.multihost import is_primary_host, shard_work
from rollingdepth_torch.parallel.sharding import param_split_dims
from rollingdepth_torch.pipelines.snippets import current_gap, snippet_index_matrix
from rollingdepth_tpu import training as jt
from rollingdepth_tpu.models.unet import UNet2DCondition, unet_apply
from rollingdepth_tpu.models.unet import UNetConfig as JUNetConfig
from rollingdepth_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rollingdepth_tpu.ops import quant as jq
from rollingdepth_tpu.parallel.sharding import shard_params as jax_shard_params
from rollingdepth_tpu.parallel.sharding import unet_param_sharding as jax_unet_param_sharding
from rollingdepth_tpu.pipelines.rollingdepth import RollingDepthPipeline as JRollingDepthPipeline
from rollingdepth_tpu.schedulers.ddim import DDIMConfig as JDDIMConfig
from rollingdepth_tpu.schedulers.ddim import DDIMScheduler as JDDIMScheduler
from tests.test_torch_pipeline import _jax_parts
from tests.test_torch_training import _jax_draws

torch.set_num_threads(2)


def _inputs():
    """Everything the ranks need, as numpy arrays and torch state dicts."""
    rng = np.random.default_rng(0)
    mlp = {"x": rng.standard_normal((3, 5, 8)), "w1": rng.standard_normal((16, 8)) * 0.3,
           "b1": rng.standard_normal(16), "w2": rng.standard_normal((8, 16)) * 0.3, "b2": rng.standard_normal(8),
           "gy": rng.standard_normal((3, 5, 8))}
    mlp = {k: v.astype(np.float32) for k, v in mlp.items()}

    tp_cfg = JUNetConfig(**R.TP_UNET)
    tp_params = UNet2DCondition(tp_cfg).init(jax.random.PRNGKey(0))

    ucfg, unet_params, vae_params = _jax_parts()
    text = np.random.default_rng(5).standard_normal((1, 2, 8)).astype(np.float32)

    train_cfg = JUNetConfig(**R.TRAIN_UNET)
    train_params = UNet2DCondition(train_cfg).init(jax.random.PRNGKey(0))
    batches = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        lat = lambda: r.standard_normal((4, 2, 8, 8, 4)).astype(np.float32)  # noqa: E731
        batches.append({"rgb_latent": lat(), "depth_latent": lat(),
                        "text_embed": r.standard_normal((1, 2, 16)).astype(np.float32)})
    draws = [_jax_draws(jax.random.PRNGKey(4 + i), b) for i, b in enumerate(batches)]
    frames = (rng.random((9, 3, 32, 32)) * 255).astype(np.uint8)
    return {
        "mlp": mlp,
        "unet_sd": state_dict_from_jax(tp_params),
        "unet_x": rng.standard_normal((2, 3, 16, 16, 8)).astype(np.float32),
        "unet_text": rng.standard_normal((1, 2, 32)).astype(np.float32),
        "pipe": {"unet": state_dict_from_jax(unet_params), "vae": state_dict_from_jax(vae_params), "text": text},
        "frames": frames,
        "noise": rng.standard_normal((4, 16, 16)).astype(np.float32),
        "train": {"sd": state_dict_from_jax(train_params), "batch": batches[0], "t": draws[0][0].numpy(),
                  "noise": draws[0][1].numpy(), "batch2": batches[1], "t2": draws[1][0].numpy(),
                  "noise2": draws[1][1].numpy()},
    }, (tp_cfg, tp_params), (ucfg, unet_params, vae_params, text), (train_cfg, train_params)


def _jax_refs(inp, tp_pair, pipe_parts, train_pair):
    tp_cfg, tp_params = tp_pair
    refs = {"unet": np.asarray(unet_apply(tp_params, tp_cfg, jnp.asarray(inp["unet_x"]), jnp.full((2,), 500),
                                          jnp.asarray(inp["unet_text"])))}
    # W8A8: JAX's quantized tree on a (2, 2) mesh of the conftest's CPU
    # devices, each dp shard's windows under shard_map (as the pipelines
    # run them; manual over dp) and tp left to GSPMD, whose abs-max spans
    # the whole tensor
    qparams = jq.quantize_unet_params(tp_params)
    jmesh = jax_make_mesh(jax.devices()[:4], (2, 2))

    def sharded(p, x):
        def chunk(xs):
            return unet_apply(p, tp_cfg, xs, jnp.full((xs.shape[0],), 500), jnp.asarray(inp["unet_text"]))

        return jax.shard_map(chunk, mesh=jmesh, in_specs=P("dp"), out_specs=P("dp"), check_vma=False,
                             axis_names=frozenset({"dp"}))(x)

    x = jax.device_put(jnp.asarray(inp["unet_x"]), NamedSharding(jmesh, P("dp")))
    refs["w8a8_sharded"] = np.asarray(jax.jit(sharded)(jax_shard_params(qparams, jmesh), x))
    refs["w8a8_halves"] = np.concatenate([
        np.asarray(unet_apply(qparams, tp_cfg, jnp.asarray(h), jnp.full((1,), 500), jnp.asarray(inp["unet_text"])))
        for h in np.split(inp["unet_x"], 2)])
    ucfg, unet_params, vae_params, text = pipe_parts
    from rollingdepth_tpu.models.vae import AutoencoderKL as JAutoencoderKL
    from rollingdepth_tpu.models.vae import VAEConfig as JVAEConfig

    jpipe = JRollingDepthPipeline(UNet2DCondition(ucfg), unet_params, JAutoencoderKL(JVAEConfig.tiny()), vae_params,
                                  JDDIMScheduler(JDDIMConfig(**R.DEPTH_SCHED)), jnp.asarray(text), dtype=jnp.float32,
                                  snippet_batch=4)
    refs["depth"] = {}
    for name in ("fast_1", "exact_1", "refine_1"):
        out = jpipe.forward(inp["frames"], init_noise=inp["noise"], **R.DEPTH_CALLS[name])
        refs["depth"][name] = {"depth": np.asarray(out.depth_pred),
                               "snippet_ls": [np.asarray(g) for g in out.snippet_ls]}
    # the windows' latents: JAX's snippet denoise on the port's frame latents
    port = R.depth_pipeline(inp["pipe"])
    frames = torch.from_numpy(inp["frames"]).permute(0, 2, 3, 1).float() / 127.5 - 1.0
    with torch.no_grad():
        rgb_latent = jnp.asarray(port._encode(frames, 4, {}).numpy())
    idx = np.concatenate([snippet_index_matrix(9, 3, d) for d in R.WINDOWS["dilations"]])
    refs["windows"] = np.asarray(jpipe._infer_snippets(rgb_latent, jnp.asarray(inp["noise"].transpose(1, 2, 0)),
                                                       idx, 1))
    refs["windows_rgb_latent"] = np.asarray(rgb_latent)

    train_cfg, train_params = train_pair
    tcfg = jt.TrainConfig(**dataclasses.asdict(R.TRAIN_CFG))
    step = jax.jit(jt.make_train_step(train_cfg, JDDIMScheduler(JDDIMConfig(**R.TRAIN_SCHED)), tcfg))
    state, metrics = step(jt.init_train_state(train_params, tcfg),
                          {k: jnp.asarray(v) for k, v in inp["train"]["batch"].items()}, jax.random.PRNGKey(4))
    refs["train"] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "params": state_dict_from_jax(state.params)}
    return refs


def _port_refs(inp):
    """The unsharded port: the depth calls and the relight call, on one
    thread as each rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"depth": R.run_depth(R.depth_pipeline(inp["pipe"]), inp["frames"], inp["noise"]),
                "relight": R.run_relight(R.relight_pipeline()), "w8a8": R.w8a8_unet(inp)}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    inp, tp_pair, pipe_parts, train_pair = _inputs()
    torch.save(inp, d / "inputs.pt")
    ckpt = str(d / "train_state.pt")
    ranks = start_ranks(R.rank_main, 4, args=(str(d / "inputs.pt"), ckpt), device="cpu", threads=1, timeout=240)
    try:
        refs = _jax_refs(inp, tp_pair, pipe_parts, train_pair)
        port = _port_refs(inp)
    except BaseException:
        ranks.kill()
        raise
    results = ranks.join()
    return {"inp": inp, "jax": refs, "port": port, "ranks": results, "ckpt": torch.load(ckpt, weights_only=True)}


# ---- the mesh and the parameter layout (no ranks)


def _jax_split_dims(params, mesh) -> dict:
    """JAX's PartitionSpecs as the port's split dims under diffusers names:
    each leaf filled with a code (1: the torch weight's dim 0, i.e. the
    kernel's out axis or a bias; 2: dim 1; 0: replicated) and carried
    through ``state_dict_from_jax`` (transposes, the GEGLU fusion)."""
    specs = jax_unet_param_sharding(params, mesh)

    def code(leaf, spec):
        s = tuple(spec.spec)
        if "tp" not in s:
            return np.zeros(leaf.shape, np.float32)
        axis_ = s.index("tp")
        c = 1 if (leaf.ndim == 1 or axis_ == leaf.ndim - 1) else 2
        return np.full(leaf.shape, c, np.float32)

    coded = state_dict_from_jax(jax.tree.map(code, params, specs))
    out = {}
    for name, t in coded.items():
        vals = set(np.unique(t.numpy()).tolist())
        assert len(vals) == 1, name
        out[name] = {0: None, 1: 0, 2: 1}[int(vals.pop())]
    return out


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["tp2", "tp4"])
def test_param_split_dims_match_jax_specs(shape):
    """Every parameter of ``UNetConfig.tiny()`` (2 heads a block) on JAX's
    8-device CPU mesh.  At tp = 4 the heads do not split, so the port keeps
    each block's q/k/v/out whole where JAX splits their columns; the rest
    agrees."""
    params = UNet2DCondition(JUNetConfig.tiny()).init(jax.random.PRNGKey(0))
    want = _jax_split_dims(params, jax_make_mesh(shape=shape))
    unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    got = param_split_dims(unet, shape[1])
    assert got.keys() == want.keys()
    attn = {n for n in got if ".attn1." in n or ".attn2." in n}
    if shape[1] == 2:
        assert got == want
        assert sum(d is not None for d in got.values()) == 44  # 4 blocks of 11: (q, k, v, out) x 2, ff 3
    else:
        assert all(got[n] is None for n in attn) and any(want[n] is not None for n in attn)
        assert {n: d for n, d in got.items() if n not in attn} == {n: d for n, d in want.items() if n not in attn}


def test_sd2_replicated_attention_levels():
    """SD2's heads (5, 10, 20, 20): at tp = 2 level 0 keeps its attention
    whole, at tp = 4 levels 0 and 1; feed-forwards split everywhere."""
    cfg = UNetConfig.sd21()
    unet = UNet2DConditionModel(dataclasses.replace(cfg, block_out_channels=(40, 80, 160, 160),
                                                    cross_attention_dim=8, norm_num_groups=8), device="cpu")
    for tp, whole_levels in ((2, {0}), (4, {0, 1})):
        split = param_split_dims(unet, tp)
        for name, dim in split.items():
            if name.endswith("attn1.to_q.weight"):
                level = int(name.split(".")[1]) if name.startswith("down_blocks") else (
                    3 - int(name.split(".")[1]) if name.startswith("up_blocks") else 3)
                assert (dim is None) == (level in whole_levels), (tp, name)
            if name.endswith("ff.net.0.proj.weight"):
                assert dim == 0, name


def test_shard_work_and_primary_single_process():
    items = [f"clip{i}" for i in range(7)]
    shards = [shard_work(items, process_id=p, num_processes=3) for p in range(3)]
    assert sorted(sum(shards, [])) == sorted(items)
    assert shards[0] == ["clip0", "clip3", "clip6"]
    assert all(not set(a) & set(b) for a, b in zip(shards, shards[1:]))
    assert shard_work(items) == items
    assert is_primary_host() and not is_primary_host(1)


def test_make_mesh_needs_a_process_group():
    from rollingdepth_torch.parallel.mesh import make_mesh
    from rollingdepth_torch.parallel.multihost import initialize_distributed, local_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        local_mesh((1, 1), "cpu")
    assert initialize_distributed() is None  # no torchrun variable: a single process


# ---- the ranks


def test_ranks_mesh_and_work(world):
    ranks = world["ranks"]
    assert [(r["dp"], r["tp"]) for r in ranks] == [((2, 0), (2, 0)), ((2, 0), (2, 1)), ((2, 1), (2, 0)),
                                                   ((2, 1), (2, 1))]
    shards = [r["shard_work"] for r in ranks]
    assert sorted(sum(shards, [])) == list(range(7)) and shards[0] == [0, 4]
    assert [r["primary"] for r in ranks] == [True, False, False, False]


def _mlp_reference(mlp):
    t = {k: torch.from_numpy(v).clone().requires_grad_() for k, v in mlp.items() if k != "gy"}
    y = F.linear(F.gelu(F.linear(t["x"], t["w1"], t["b1"])), t["w2"], t["b2"])
    (y * torch.from_numpy(mlp["gy"])).sum().backward()
    return y.detach().numpy(), {k: v.grad.numpy() for k, v in t.items()}


def test_megatron_f_and_g(world):
    """f and g against the unsharded linear pair; the library all-reduce
    as g multiplies the gradients by tp, and this check catches it."""
    y, grads = _mlp_reference(world["inp"]["mlp"])
    for use_library in (False, True):
        ok = True
        for r in world["ranks"]:
            got, tp_rank = r["mlp_library_g" if use_library else "mlp"], r["tp"][1]
            np.testing.assert_allclose(got["y"], y, atol=1e-6)
            want = {"x": grads["x"], "b2": grads["b2"], "w1": np.split(grads["w1"], 2, 0)[tp_rank],
                    "b1": np.split(grads["b1"], 2, 0)[tp_rank], "w2": np.split(grads["w2"], 2, 1)[tp_rank]}
            ok &= all(np.allclose(got[k], v, atol=1e-6, rtol=0) for k, v in want.items())
            if use_library:
                np.testing.assert_allclose(got["x"], 2 * grads["x"], atol=1e-5)
        assert ok != use_library


def test_tp2_unet_matches_jax(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["unet_tp2"], world["jax"]["unet"], atol=2e-5, rtol=2e-5)
        before, after = r["split_before_after"]
        assert before == after and sum(d is not None for d in before.values()) == 44


def _drift(got, ref):
    """(correlation, rms of the difference over the reference's spread), the
    drift measures of ``tests/test_quant.py``."""
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    return np.corrcoef(got, ref)[0, 1], np.sqrt(((got - ref) ** 2).mean()) / ref.std()


def test_dp_tp_w8a8_unet_matches_jax(world):
    """The W8A8 UNet on the (2, 2) mesh, one window per dp rank.  Against
    the unsharded port on the same window, bit for bit: the row-parallel
    shards sum exact int32 partials under one all-reduced activation scale
    (a shard that scales by its own abs-max must part from it by over 1%
    rms).  Against JAX's sharded W8A8 (shard_map over dp, GSPMD over tp),
    JAX's bounds for a quantized UNet (correlation above 0.99, rms below
    0.1 of the spread), which also hold JAX's sharded call to its unsharded
    one: a rounding that flips between fp32 sum orders cascades through the
    int8 layers, so no fp tolerance holds."""
    want, halves = world["jax"]["w8a8_sharded"], world["jax"]["w8a8_halves"]
    corr, rel_rms = _drift(want, halves)  # JAX's scale is per dp shard, as the port's
    assert corr > 0.99 and rel_rms < 0.1
    alone = world["port"]["w8a8"]["w8a8"]
    for r in world["ranks"]:
        dp_rank = r["dp"][1]
        got = r["w8a8"]["w8a8"]
        np.testing.assert_array_equal(got, alone[dp_rank : dp_rank + 1])
        corr, rel_rms = _drift(got, want[dp_rank : dp_rank + 1])
        assert corr > 0.99 and rel_rms < 0.1, (corr, rel_rms)
        assert _drift(r["w8a8"]["local_absmax"], alone[dp_rank : dp_rank + 1])[1] > 0.01


def test_collectives_in_unet_calls(world):
    """No collective inside a UNet call at tp = 1 (the dp denoise gathers
    once after its UNet calls); at tp = 2 one all-reduce per row-parallel
    linear (attn1's and attn2's ``to_out``, the feed-forward's ``net.2``):
    three per transformer block, and as many again backward (f on the
    inputs of attn1, attn2 and the feed-forward)."""
    for r in world["ranks"]:
        c = r["collectives"]
        assert sum(c["tp1_pipeline"]["inside_unet"].values()) == 0 and c["tp1_pipeline"]["unet_calls"] > 0
        assert c["tp1_pipeline"]["whole_call"]["all_gather"] == 1
        assert c["tp1_pipeline"]["whole_call"]["all_reduce"] == 0
        assert sum(c["tp1_unet"].values()) == 0
        blocks = c["transformer_blocks"]
        assert c["sharded_blocks"] == blocks == 4
        assert c["tp2_no_grad"] == dict(c["tp2_no_grad"], all_reduce=3 * blocks)
        assert sum(c["tp2_no_grad"].values()) == 3 * blocks
        assert c["tp2_grad"]["all_reduce"] == 6 * blocks and sum(c["tp2_grad"].values()) == 6 * blocks


def test_dp_tp_windows_match_jax(world):
    """The windows' latents of the fast call (15 windows, an odd count over
    dp = 2) against JAX's snippet denoise, on every rank."""
    want = world["jax"]["windows"]
    for r in world["ranks"]:
        got = r["depth"]["fast_1"]["windows"]
        assert got.shape == want.shape == (15, 3, 16, 16, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name, tol", [("fast_1", 1e-4), ("exact_1", 2e-4), ("refine_1", 2e-4)])
def test_dp_tp_depth_matches_jax_at_one_iteration(world, name, tol):
    """The bounds of ``test_torch_pipeline.py`` (fast) and ``test_torch_refine.py``."""
    want = world["jax"]["depth"][name]
    for r in world["ranks"]:
        got = r["depth"][name]
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=0, atol=tol)
        assert len(got["snippet_ls"]) == len(want["snippet_ls"])
        for g, w in zip(got["snippet_ls"], want["snippet_ls"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["fast_full", "refine_full", "fast_1", "exact_1", "refine_1"])
def test_dp_tp_depth_matches_unsharded_port(world, name):
    """Against the unsharded port: the full solve within 5e-3, and each
    rank's chunks are its block's (8 of the 15 windows at 4 a chunk)."""
    want = world["port"]["depth"][name]
    for r in world["ranks"]:
        got = r["depth"][name]
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(got["windows"], want["windows"], rtol=1e-5, atol=1e-5)
        assert got["chunks"]["unet"] == 2 and want["chunks"]["unet"] == 4
        if name.startswith("exact"):  # the depth-space merge decodes this rank's 23 of 45 window frames
            assert got["chunks"]["decode"] == 6 and want["chunks"]["decode"] == 12
        if name.startswith("refine"):  # each step's stride-1 windows in blocks of ceil(S / 2)
            start = R.WINDOWS["refine_start_dilation"]
            sizes = [snippet_index_matrix(9, 3, current_gap(i, 2, start, 1) + 1).shape[0] for i in range(2)]
            assert got["chunks"]["refine_unet"] == sum(-(-(-(-s // 2)) // 4) for s in sizes)
            assert want["chunks"]["refine_unet"] == sum(-(-s // 4) for s in sizes)


def test_dp_tp_relight_matches_unsharded_port(world):
    want = world["port"]["relight"]
    for r in world["ranks"]:
        got = r["relight"]
        assert len(got["snippet_ls"]) == 3
        for g, w in zip(got["snippet_ls"], want["snippet_ls"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
        np.testing.assert_allclose(got["rgb"], want["rgb"], rtol=0, atol=1e-5)
        # 9 windows: this rank's 5 at 2 a chunk (3 chunks), against 5 chunks, each step
        assert got["chunks"]["unet"] * 5 == want["chunks"]["unet"] * 3


# the dp x tp step's parameters against JAX's after one step: each
# parameter's mean |difference| within TRAIN_PARAMS_MEAN_TOL (sound runs
# read 5.2e-8; a shard whose update is skipped reads about lr / 2 = 5e-4),
# and every element within 1e-6 + 2.2 lr (a gradient near 0 whose sign
# differs from JAX's parts an element by up to 2 lr; sound runs read 4.5e-5)
TRAIN_PARAMS_MEAN_TOL = 1e-6


def _params_apart(got, want) -> tuple:
    """(largest |difference| of an element, largest mean |difference| of a parameter)."""
    diffs = [np.abs(got[n] - w.numpy()) for n, w in want.items()]
    return max(float(d.max()) for d in diffs), max(float(d.mean()) for d in diffs)


def test_dp_tp_train_step_matches_jax(world):
    want, lr = world["jax"]["train"], R.TRAIN_CFG.learning_rate
    for r in world["ranks"]:
        t = r["train"]
        assert t["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert t["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    ckpt = world["ckpt"]
    assert ckpt["step"] == 1
    got = {n: t.numpy() for n, t in ckpt["model"].items()}
    assert got.keys() == want["params"].keys()
    worst, worst_mean = _params_apart(got, want["params"])
    assert worst <= 1e-6 + 2.2 * lr and worst_mean <= TRAIN_PARAMS_MEAN_TOL
    full = sum(p.numel() for p in want["params"].values())
    assert all(ckpt["optimizer"]["state"][i]["exp_avg"].shape == p.shape
               for i, p in enumerate(ckpt["model"].values()))
    assert all(r["train"]["local_numel"] < full for r in world["ranks"])


@pytest.mark.parametrize("scale", [0.0, 2.0, -1.0], ids=["skipped", "doubled", "sign_flipped"])
def test_train_params_check_catches_a_faulty_shard(world, scale):
    """A planted fault: tp rank 1's shard of one split parameter moved by
    ``scale`` times its update; the parameter check above refuses it."""
    want = world["jax"]["train"]["params"]
    got = {n: t.numpy() for n, t in world["ckpt"]["model"].items()}
    split = param_split_dims(UNet2DConditionModel(UNetConfig(**R.TRAIN_UNET), device="cpu"), 2)
    name = next(n for n, d in split.items() if d is not None)
    before, dim = world["inp"]["train"]["sd"][name].numpy(), split[name]
    half = before.shape[dim] // 2
    shard = lambda a: np.take(a, range(half, 2 * half), dim)  # noqa: E731
    planted = shard(before) + scale * (shard(got[name]) - shard(before))
    faulty = dict(got, **{name: np.concatenate([np.take(got[name], range(half), dim), planted], dim)})
    assert _params_apart(faulty, want)[1] > TRAIN_PARAMS_MEAN_TOL


def test_sharded_checkpoint_round_trip(world):
    for r in world["ranks"]:
        t = r["train"]
        assert t["restored_step"] == 1
        assert t["second_step_equal"] and t["second_step_params_max_diff"] == 0.0
