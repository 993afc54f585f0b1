"""Sharded training in the port against its unsharded step and against the
JAX package's step on its mesh (twins of tests/test_sharding.py's training
cases: test_lora_training_step_decreases_loss, test_full_finetune_step_runs,
test_lora_merge_matches_functional), with the int4 row shards at split
groups.

The port runs sharded on a pool of 4 gloo worker processes
(tests/torch_gloo_pool.py; workers run tests/torch_mesh_work.py on one
torch thread), at tp 2 and at dp 2 × tp 2, and unsharded in this process;
the JAX package runs make_train_step on the conftest's 8 virtual CPU
devices (dp 2 × tp 4). Same numpy weights, adapters and batches on every
side, f32.

Sharded against unsharded (both the port's step; only the order of the tp
sums and the dp split differ): the loss of every step and every element of
the last step's gradients within 1e-5, and every trained element within
1e-5 — except where Adam divides a gradient at f32 rounding level by its
own magnitude, which steps by the noise: there (measured: 0–5 elements a
leaf of a full fine-tune, at most 0.045 learning rates; none in LoRA)
within NOISE_LR learning rates, in at most 1e-4 of the elements. The
gradients are what catch a wrong sum: Adam's update does not change when a
gradient is scaled, so a norm gradient summed over tp (doubled) trains the
same leaves. Against JAX, tests/test_torch_training.py's tolerances in
learning rates, with NOISE_LR for the largest element (measured 0.032 at
this width and three steps, where that file measured 0.015 for two).
"""

import dataclasses

import numpy as np
import pytest

from tests import torch_mesh_work as W
from tests.test_torch_sharding import CFG, MESHES, ids
from tests.test_torch_training import LEAF_TOL_Q, LOSS_RTOL, _pairs
from tests.torch_gloo_pool import GlooPool
from tests.torch_port_helpers import numpy_llama_tree, port_config, to_jax
from tts_inference_tpu.config import MeshConfig

TOL = 1e-5
NOISE_LR = 0.1
LR, LR_FULL = 1e-2, 1e-3      # tests/test_torch_training.py's
STEPS = 3


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread, as the workers run."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n=STEPS, b=4, s=16, seed=2):
    """One batch of uneven lengths, n times (so the loss must fall)."""
    rng = np.random.default_rng(seed)
    lens = np.array([16, 12, 9, 16], np.int32)[:b]
    tokens = rng.integers(0, CFG.vocab_size, size=(b, s)).astype(np.int32)
    return [(tokens, lens)] * n


def _agree(pool, dp, tp, **kw):
    """Every member rank's result, equal across ranks; and the
    unsharded step's."""
    outs = [o for o in pool.run("train_run", dp=dp, tp=tp, **kw)
            if o is not None]
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
        for _, a, b in _pairs(o["tree"], outs[0]["tree"]):
            np.testing.assert_array_equal(a, b)
    return outs[0], W.train_run(**kw)


def _close(got, want, lr=LR):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
    grads = _pairs(got["grads"], want["grads"])
    assert len(grads) == len(_pairs(got["tree"], want["tree"]))
    for path, a, b in grads:
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)
    d = np.concatenate([np.abs(a - b).ravel() for _, a, b in
                        _pairs(got["tree"], want["tree"])])
    assert (d > TOL).sum() <= 1e-4 * d.size, (d > TOL).sum()
    assert d.max() <= NOISE_LR * lr, d.max()


_JAX = {}


def _jax_train(full):
    """JAX's make_train_step on its dp 2 × tp 4 mesh, optax adamw with the
    cosine schedule (the port's make_optimizer), over the same weights,
    adapters and batches (memoized)."""
    if full in _JAX:
        return _JAX[full]
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tts_inference_tpu.parallel import mesh as JM
    from tts_inference_tpu.training import lora as jL
    from tts_inference_tpu.training.train_step import (init_train_state,
                                                       make_train_step)

    mesh = JM.make_mesh(MeshConfig(dp=2, tp=4))
    params = JM.shard_tree(to_jax(numpy_llama_tree(CFG, 0)),
                           JM.llama_param_pspecs(CFG), mesh)
    opt = optax.adamw(optax.cosine_decay_schedule(LR_FULL if full else LR,
                                                  STEPS),
                      weight_decay=0.01)
    if full:
        trainable, base = params, None
    else:
        lora = jax.tree.map(jnp.asarray, W.numpy_adapters(CFG, 1))
        trainable = JM.shard_tree(lora, jL.lora_pspecs(CFG, lora), mesh)
        base = params
    state = init_train_state(trainable, opt)
    step = jax.jit(make_train_step(CFG, opt, base_params=base,
                                   lora_scale=2.0))
    losses = []
    with mesh:
        for tokens, lens in _batches():
            state, loss = step(
                state, jax.device_put(tokens,
                                      NamedSharding(mesh, P("dp", None))),
                jax.device_put(lens, NamedSharding(mesh, P("dp"))))
            losses.append(float(loss))
    out = {"losses": losses,
           "tree": jax.tree.map(np.asarray, state.params)}
    _JAX[full] = out
    return out


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
@pytest.mark.parametrize("full", [False, True], ids=["lora", "full"])
def test_sharded_train_step_matches(pool, full, dp, tp):
    """Three steps, LoRA (A, B on the 7 targets) or full fine-tune (every
    leaf, norms and embedding included), under tp and dp × tp: the loss of
    each step and every trained leaf, gathered whole, within 1e-5 of the
    unsharded step, and within the Adam-noise tolerance of JAX's step on
    its mesh. A norm gradient summed over tp would double the norms' update;
    a missing tp sum of A (column targets) or B (row targets) would halve
    theirs."""
    lr = LR_FULL if full else LR
    kw = dict(cfg=port_config(CFG), batches=_batches(), full=full, lr=lr)
    got, want = _agree(pool, dp, tp, **kw)
    _close(got, want, lr)
    assert got["losses"][-1] < got["losses"][0]
    jax_out = _jax_train(full)
    np.testing.assert_allclose(got["losses"], jax_out["losses"],
                               rtol=LOSS_RTOL)
    init = (numpy_llama_tree(CFG, 0) if full
            else W.numpy_adapters(CFG, 1))
    pairs = _pairs(got["tree"], jax_out["tree"])
    d = np.concatenate([np.abs(g - np.asarray(w)).ravel()
                        for _, g, w in pairs]) / lr
    assert d.max() <= NOISE_LR, d.max()       # measured 0.032
    assert np.quantile(d, 0.999) <= LEAF_TOL_Q, np.quantile(d, 0.999)
    moved = np.concatenate([np.abs(np.asarray(w) - np.asarray(i)).ravel()
                            for (_, _, w), (_, _, i)
                            in zip(pairs, _pairs(jax_out["tree"], init))])
    assert moved.mean() >= 0.1 * lr


def test_lora_pspecs_match_jax_structure():
    """lora_pspecs: the JAX function's tree, a tuple where it has a
    PartitionSpec."""
    import jax.numpy as jnp

    from tts_inference_tpu.training import lora as jL
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.training import lora as L

    ad = W.numpy_adapters(CFG, 1)
    got = L.lora_pspecs(port_config(CFG), weights.lora_from_jax(ad))
    want = jL.lora_pspecs(CFG, {"layers": [
        {t: {k: jnp.asarray(v) for k, v in ab.items()}
         for t, ab in le.items()} for le in ad["layers"]]})
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert list(g) == list(w)
        for t in g:
            assert list(g[t]) == list(w[t])
            for k in g[t]:
                assert g[t][k] == tuple(w[t][k])


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
def test_init_lora_under_a_mesh_is_the_cut(pool, dp, tp):
    """init_lora(mesh=) on a shard draws the whole adapters and cuts them:
    the same tensors as the cut of the unsharded init from the seed."""
    outs = [o for o in pool.run("lora_init_cut", cfg=port_config(CFG),
                                dp=dp, tp=tp) if o is not None]
    assert outs and all(outs)


@pytest.mark.parametrize("dp,tp", MESHES, ids=ids)
def test_sharded_merge_is_the_cut_of_the_merge(pool, dp, tp):
    """merge_params stays local to each shard: A replicated and B cut for
    the column targets, A cut and B replicated for the row targets, the
    merged shard within f32 rounding of the cut of the whole merge."""
    outs = [o for o in pool.run("merge_cut", cfg=port_config(CFG), dp=dp,
                                tp=tp) if o is not None]
    assert len(outs) == dp * tp and max(outs) <= 1e-6


def test_lora_merge_matches_functional():
    """tests/test_sharding.py::test_lora_merge_matches_functional on the
    port: zero-B adapters leave the weights as they are; a nonzero B moves
    them by exactly scale·A@B."""
    import torch

    from tts_inference_tpu_torch.training import lora as L

    cfg = port_config(CFG)
    params = W._params(cfg, 0)
    lora = L.init_lora(torch.Generator().manual_seed(5), cfg, params, r=4)
    merged = L.merge_params(params, lora, scale=2.0)
    assert torch.equal(merged["layers"][0]["wq"], params["layers"][0]["wq"])
    lora["layers"][0]["wq"]["B"] = torch.ones_like(lora["layers"][0]["wq"]
                                                   ["B"])
    merged = L.merge_params(params, lora, scale=0.5)
    delta = merged["layers"][0]["wq"] - params["layers"][0]["wq"]
    want = 0.5 * lora["layers"][0]["wq"]["A"] @ torch.ones(
        (4, CFG.num_attention_heads * CFG.head_dim))
    np.testing.assert_allclose(delta.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_loss_equals_the_gathered_one(pool, tp):
    """The loss's log-softmax over the vocabulary partition (the shift and
    the sum of exponentials over tp, the target's logit from its owner) at
    Orpheus-3B's vocabulary (text, specials and audio targets): its value
    and its gradients — of the hidden states and of each rank's embedding
    block, gathered — within f32 rounding of log_softmax over the whole
    logits."""
    outs = [o for o in pool.run("vocab_loss", vocab=156940, hidden=16,
                                tp=tp) if o is not None]
    assert len(outs) == tp
    for o in outs:
        np.testing.assert_allclose(o["nll"], o["want"], rtol=1e-5, atol=1e-5)
        # a hidden state's gradient sums 156,940 rows, in blocks here
        np.testing.assert_allclose(o["g_h"], o["want_g_h"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(o["g_emb"], o["want_g_emb"], rtol=1e-4,
                                   atol=1e-7)
        # the logits gathered over tp differentiate to the same
        np.testing.assert_allclose(o["g_h_gathered"], o["want_g_h"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o["g_emb_gathered"], o["want_g_emb"],
                                   rtol=1e-4, atol=1e-7)


# ---- int4 weights under tp at split groups ----------------------------------


@pytest.mark.parametrize("k,group,tp,shard_group", [
    (3072, 512, 2, 256),     # Orpheus-3B o at tp 2
    (8192, 512, 2, 512),     # Orpheus-3B down at tp 2
    (128, 32, 4, 16),        # the tiny configs at tp 4
], ids=["o-tp2", "down-tp2", "tiny-tp4"])
def test_int4_row_shard_is_bit_equal(pool, k, group, tp, shard_group):
    """A row shard cut inside a group: the shard's group is the largest
    that divides both the checkpoint's and each packed half of the shard,
    its dequantized rows are bit-equal to the whole matrix's, and the
    shards gathered back at the checkpoint's group are the whole matrix
    byte for byte."""
    outs = [o for o in pool.run("int4_cut_rows", k=k, n=64, group=group,
                                tp=tp) if o is not None]
    assert len(outs) == tp
    for o in outs:
        assert o["equal"] and o["back"] and o["group"] == shard_group


_JAX_I4 = {}


def _jax_int4_first(group):
    """tests/test_sharding.py::test_sharded_int4_engine_matches's run on
    the JAX package's dp 2 × tp 4 mesh, at `group`, over the numpy weights
    (memoized)."""
    if group in _JAX_I4:
        return _JAX_I4[group]
    from tts_inference_tpu.config import SamplingConfig
    from tts_inference_tpu.engine.engine import EngineCore
    from tts_inference_tpu.models.quant import quantize_llama_params
    from tts_inference_tpu.ops import sampling as S
    from tts_inference_tpu.parallel import mesh as JM

    from tests.test_torch_sharding import QUANT

    q = quantize_llama_params(to_jax(numpy_llama_tree(CFG, 0)), bits=4,
                              group=group)
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), 4)
    core = EngineCore(q, CFG, QUANT, eos_id=5,
                      mesh=JM.make_mesh(MeshConfig(dp=2, tp=4)))
    first = core.prefill_slots([[7, 8, 9]], [0], sp)
    toks, _, _ = core.decode_steps(sp, first,
                                   np.array([True, False, False, False]))
    _JAX_I4[group] = np.concatenate([first[:1, None], toks[:1]], axis=1)
    return _JAX_I4[group]


@pytest.mark.parametrize("dp,tp,group", [(1, 4, 32), (2, 2, 32),
                                         (1, 4, 512)],
                         ids=["tp4-g32", "dp2xtp2-g32", "tp4-g512"])
def test_sharded_int4_engine_at_split_groups(pool, dp, tp, group):
    """The int4 engine (o and down row shards at the split group: 16 at tp
    4) gives the unsharded port's tokens and those of the JAX package's
    sharded int4 engine (dp 2 × tp 4, as its own test runs it). Group 512
    is the default, which the tiny K of 128 shrinks to 64."""
    from tests.test_torch_sharding import QUANT, _sharded

    kw = dict(cfg=port_config(CFG), ecfg=port_config(QUANT),
              script="first", bits=4)
    got = _sharded(pool, "engine_run", dp=dp, tp=tp, i4_group=group, **kw)
    np.testing.assert_array_equal(got, W.engine_run(i4_group=group, **kw))
    np.testing.assert_array_equal(got, _jax_int4_first(group))
