"""The port's training modules against the JAX package's on the CPU: data
(records, sequences, batches, the dataset-dir reader, the census), LoRA
(init, merge), the loss, LoRA and full-finetune steps against optax's
AdamW with the cosine schedule, ``CheckpointManager``, and the two token /
audio tools. Inputs are made with numpy from seeds; each side gets the same
arrays."""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tts_inference_tpu import protocol as jP
from tts_inference_tpu.config import tiny_config
from tts_inference_tpu.tools import analyze_tokens as jAT
from tts_inference_tpu.tools import audio_fidelity as jAF
from tts_inference_tpu.training import data as jD
from tts_inference_tpu.training import lora as jL
from tts_inference_tpu.training import train_step as jT
from tts_inference_tpu.utils.tokenizer import ByteTokenizer as JByteTokenizer
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.models import quant
from tts_inference_tpu_torch.tools import analyze_tokens as AT
from tts_inference_tpu_torch.tools import audio_fidelity as AF
from tts_inference_tpu_torch.training import data as D
from tts_inference_tpu_torch.training import lora as L
from tts_inference_tpu_torch.training import train_step as T
from tts_inference_tpu_torch.training.checkpoint import CheckpointManager
from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

from tests.torch_port_helpers import numpy_llama_tree, port_config, to_jax

REPO = Path(__file__).resolve().parents[1]
CFG = tiny_config()
TCFG = port_config(CFG)
# f32 on both sides; the sums run in another order (XLA vs ATen), so the
# losses agree to f32 rounding (measured: <= 3.3e-7 relative). Adam divides
# each gradient by its own magnitude, so an element whose gradient is at
# that rounding's level takes a step whose size depends on the noise: the
# trained leaves agree within LEAF_TOL_MAX learning rates everywhere
# (measured: 0.015) and within LEAF_TOL_Q learning rates in 99.9% of the
# elements (measured: 2.6e-4). A wrong moment, bias correction, decay or
# schedule count moves every element by a good part of a learning rate.
LOSS_RTOL = 1e-5
LEAF_TOL_MAX = 0.02
LEAF_TOL_Q = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (it runs beside other
    files' servers, which wait on starved OpenMP threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- data ----------------------------------------------------------------------


def test_mine_tags_equal():
    texts = ["<laugh> hi", "no tags", "<sigh> <laugh>", "<a_1> <1bad> <b>"]
    assert D.mine_tags(texts) == jD.mine_tags(texts) == \
        ["<a_1>", "<b>", "<laugh>", "<sigh>"]


@pytest.mark.parametrize("seed,n,frames", [(0, 12, 4), (3, 7, 1)])
def test_synthetic_records_equal(seed, n, frames):
    got = D.synthetic_records(np.random.default_rng(seed), n, frames)
    want = jD.synthetic_records(np.random.default_rng(seed), n, frames)
    assert got == want and len(got) == n


@pytest.mark.parametrize("codes", [None, [], [0, 4096, 8192, 12288, 16384,
                                              20480, 24576]])
def test_build_sequence_equal(codes):
    got = D.build_sequence(ByteTokenizer(), "<laugh> hi", "leo", codes)
    assert got == jD.build_sequence(JByteTokenizer(), "<laugh> hi", "leo",
                                    codes)
    assert got[0] == jP.TOKEN_SOH
    assert (got[-1] == jP.TOKEN_EOS) == bool(codes)


@pytest.mark.parametrize("drop", [True, False])
def test_batches_equal(drop):
    recs = D.synthetic_records(np.random.default_rng(1), n=11)
    recs[2] = {"text": "text only record"}
    got = list(D.batches(ByteTokenizer(), recs, 4, 48, drop_remainder=drop,
                         shuffle_rng=np.random.default_rng(5)))
    want = list(jD.batches(JByteTokenizer(), recs, 4, 48,
                           drop_remainder=drop,
                           shuffle_rng=np.random.default_rng(5)))
    assert len(got) == len(want) == (2 if drop else 3)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt.dtype == wt.dtype == np.int32 and gl.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)


def test_inspect_and_main_equal(capsys):
    recs = D.synthetic_records(np.random.default_rng(2), n=9)
    recs.append({"text": "<sigh> plain", "voice": "leo"})
    assert D.inspect(recs) == jD.inspect(recs)
    assert D._main(["--synthetic-records", "5"]) == 0
    ours = capsys.readouterr().out
    assert jD._main(["--synthetic-records", "5"]) == 0
    assert ours == capsys.readouterr().out
    assert json.loads(ours)["records"] == 5


def _dataset_records():
    src = D.synthetic_records(np.random.default_rng(4), n=6)
    src[0]["text"] = "<laugh> " + src[0]["text"]
    src[3]["voice"] = None
    return src


def test_load_dataset_dir_arrow_equal(tmp_path):
    datasets = pytest.importorskip("datasets")
    src = _dataset_records()
    ds = datasets.Dataset.from_dict({
        "text": [r["text"] for r in src],
        "voice": [r["voice"] for r in src],
        "codes": [r["codes"] for r in src],
        "audio_len": [len(r["codes"]) for r in src],
    })
    path = str(tmp_path / "hfds")
    ds.save_to_disk(path)
    got = D.load_dataset_dir(path)
    assert got == jD.load_dataset_dir(path)
    assert got[3]["voice"] == "tara" and "audio_len" not in got[0]


def test_load_dataset_dir_parquet_equal(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    import pyarrow as pa

    src = _dataset_records()
    d = tmp_path / "pqds"
    d.mkdir()
    for i in (0, 1):
        part = src[3 * i:3 * i + 3]
        pq.write_table(pa.table({"text": [r["text"] for r in part],
                                 "codes": [r["codes"] for r in part]}),
                       str(d / f"part-{i}.parquet"))
    got = D.load_dataset_dir(str(d))
    assert got == jD.load_dataset_dir(str(d)) and len(got) == 6
    assert [r["codes"] for r in got] == [r["codes"] for r in src]


@pytest.mark.parametrize("parquet", [True, False])
def test_load_dataset_dir_names_the_missing_package(tmp_path, monkeypatch,
                                                    parquet):
    """A GPU host may have neither pyarrow nor datasets: the reader
    imports them only when called, and a missing one raises ImportError
    naming it."""
    if parquet:
        (tmp_path / "x.parquet").write_bytes(b"")
    for m in ("pyarrow", "pyarrow.parquet", "datasets"):
        monkeypatch.setitem(sys.modules, m, None)
    with pytest.raises(ImportError,
                       match="pyarrow" if parquet else "datasets"):
        D.load_dataset_dir(str(tmp_path))


def test_load_jsonl_equal(tmp_path):
    recs = D.synthetic_records(np.random.default_rng(6), n=3)
    p = tmp_path / "d.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert D.load_jsonl(str(p)) == jD.load_jsonl(str(p)) == recs


@pytest.mark.parametrize("tied", [True, False])
def test_extend_vocab(tied):
    rng = np.random.default_rng(7)
    params = {"embed": torch.from_numpy(
        (0.05 * rng.standard_normal((100, 64))).astype(np.float32)),
        "layers": []}
    if not tied:
        params["lm_head"] = torch.from_numpy(
            rng.standard_normal((64, 100)).astype(np.float32))
    out = D.extend_vocab(params, 64, seed=3)
    assert out["embed"].shape == (164, 64)
    assert torch.equal(out["embed"][:100], params["embed"])
    std = float(params["embed"].std(correction=0))
    # 4,096 draws: the sample std is within ~1% of the scale
    assert abs(float(out["embed"][100:].std()) / std - 1) < 0.05
    if not tied:
        assert out["lm_head"].shape == (64, 164)
        assert torch.equal(out["lm_head"][:, :100], params["lm_head"])
        assert abs(float(out["lm_head"][:, 100:].std()) / std - 1) < 0.05
        # the head's columns come from seed + 1, not the rows' stream
        assert not torch.allclose(out["lm_head"][:, 100:].t(),
                                  out["embed"][100:])
    again = D.extend_vocab(params, 64, seed=3)
    assert torch.equal(again["embed"], out["embed"])
    assert not torch.equal(D.extend_vocab(params, 64, seed=4)["embed"],
                           out["embed"])
    assert D.extend_vocab(params, 0) is params
    # the JAX function: the same shapes, scale and untouched rows
    jout = jD.extend_vocab(to_jax({k: v.numpy() for k, v in params.items()
                                   if k != "layers"}), 64, seed=3)
    assert jout["embed"].shape == tuple(out["embed"].shape)
    assert abs(float(jnp.std(jout["embed"][100:])) / std - 1) < 0.05


# -- LoRA ----------------------------------------------------------------------


def _params(seed=0):
    tree = numpy_llama_tree(CFG.model, seed)
    return tree, weights.llama_params_from_jax(tree), \
        jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_lora_shapes_and_scale(dtype):
    _, params, _ = _params()
    params = jax.tree.map(lambda x: x.to(dtype), params)
    gen = torch.Generator().manual_seed(1)
    ad = L.init_lora(gen, TCFG.model, params, r=8, alpha=16)
    jad = jL.init_lora(jax.random.PRNGKey(1), CFG.model,
                       jax.tree.map(jnp.asarray, numpy_llama_tree(CFG.model)),
                       r=8, alpha=16)
    assert len(ad["layers"]) == CFG.model.num_hidden_layers
    for le, jle, lp in zip(ad["layers"], jad["layers"], params["layers"]):
        assert list(le) == list(jle) == list(L.DEFAULT_TARGETS)
        for t, ab in le.items():
            assert ab["A"].shape == jle[t]["A"].shape == (lp[t].shape[0], 8)
            assert ab["B"].shape == jle[t]["B"].shape == (8, lp[t].shape[1])
            assert ab["A"].dtype == ab["B"].dtype == dtype
            assert not ab["B"].any()
    a = torch.cat([ab["A"].float().ravel() for le in ad["layers"]
                   for ab in le.values()])
    assert abs(float(a.std()) * np.sqrt(8) - 1) < 0.02
    assert L.lora_scale(8, 16) == jL.lora_scale(8, 16) == 2.0


def _numpy_adapters(seed, r=4, b_scale=0.02):
    rng = np.random.default_rng(seed)
    tree = numpy_llama_tree(CFG.model)
    return {"layers": [{t: {
        "A": (rng.standard_normal((lp[t].shape[0], r)) / 2).astype(
            np.float32),
        "B": (b_scale * rng.standard_normal((r, lp[t].shape[1]))).astype(
            np.float32)} for t in L.DEFAULT_TARGETS}
        for lp in tree["layers"]]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_params_matches_jax(dtype):
    """f32 within 1e-6. bf16: both merge in f32 and round once; the f32
    products sum r terms in another order, so a sum within an f32 step of a
    bf16 rounding boundary may round the other way: at most one bf16 step,
    in a few elements."""
    np_tree = numpy_llama_tree(CFG.model)
    ad = _numpy_adapters(3)
    tdt = getattr(torch, dtype)
    params = jax.tree.map(lambda x: x.to(tdt),
                          weights.llama_params_from_jax(np_tree))
    lora = jax.tree.map(lambda x: x.to(tdt), weights.lora_from_jax(ad))
    got = L.merge_params(params, lora, 2.0)
    jparams = jax.tree.map(lambda x: jnp.asarray(x, dtype), np_tree)
    want = jL.merge_params(jparams, jax.tree.map(
        lambda x: jnp.asarray(x, dtype), ad), 2.0)
    assert got["embed"] is params["embed"]
    n_diff = 0
    for lp, jlp in zip(got["layers"], want["layers"]):
        for t in L.DEFAULT_TARGETS:
            g = lp[t].float().numpy()
            w = np.asarray(jlp[t].astype(jnp.float32))
            assert lp[t].dtype == tdt
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            else:
                step = 2.0 ** (np.floor(np.log2(np.abs(w) + 1e-30)) - 7)
                assert (np.abs(g - w) <= step).all()
                n_diff += int((g != w).sum())
    if dtype == "bfloat16":
        assert n_diff <= 0.001 * sum(
            lp[t].numel() for lp in got["layers"] for t in L.DEFAULT_TARGETS)


def test_merge_params_is_differentiable():
    _, params, _ = _params()
    lora = weights.lora_from_jax(_numpy_adapters(4))
    leaves = T.tree_leaves(lora)
    for x in leaves:
        x.requires_grad_(True)
    merged = L.merge_params(params, lora, 2.0)
    sum(lp[t].sum() for lp in merged["layers"]
        for t in L.DEFAULT_TARGETS).backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0 for x in leaves)
    assert not params["layers"][0]["wq"].requires_grad


# -- the train step ------------------------------------------------------------


def _batches(n, b=2, s=48, seed=9):
    recs = D.synthetic_records(np.random.default_rng(seed), n=n * b, frames=3)
    return list(D.batches(ByteTokenizer(), recs, b, s))[:n]


def test_lm_loss_matches_jax():
    np_tree, params, jparams = _params(5)
    for tokens, lens in _batches(2):
        got = T.lm_loss(params, TCFG.model, torch.from_numpy(tokens),
                        torch.from_numpy(lens))
        want = jT.lm_loss(jparams, CFG.model, jnp.asarray(tokens),
                          jnp.asarray(lens))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("steps", [1, 3, 10])
def test_make_optimizer_schedule_is_optax_cosine(steps):
    opt = T.make_optimizer(2e-4, steps)
    sched = optax.cosine_decay_schedule(2e-4, max(steps, 1))
    for count in range(steps + 3):
        assert opt.lr_at(count) == pytest.approx(float(sched(count)),
                                                 rel=1e-6, abs=1e-12)
    assert T.make_optimizer(1e-3, 0).steps == 1


def _run_jax(jparams, trainable, batches, lr, steps, lora_scale=None):
    optimizer = optax.adamw(optax.cosine_decay_schedule(lr, steps),
                            weight_decay=0.01)
    fn = jax.jit(jT.make_train_step(
        CFG.model, optimizer,
        base_params=jparams if lora_scale is not None else None,
        lora_scale=lora_scale or 2.0))
    state = jT.init_train_state(trainable, optimizer)
    losses = []
    for tokens, lens in batches:
        state, loss = fn(state, jnp.asarray(tokens), jnp.asarray(lens))
        losses.append(float(loss))
    return state.params, losses


def _run_port(params, trainable, batches, lr, steps, lora_scale=None):
    optimizer = T.make_optimizer(lr, steps)
    fn = T.make_train_step(
        TCFG.model, optimizer,
        base_params=params if lora_scale is not None else None,
        lora_scale=lora_scale or 2.0)
    state = T.init_train_state(trainable, optimizer)
    losses = []
    for tokens, lens in batches:
        state, loss = fn(state, tokens, lens)
        losses.append(float(loss))
    assert state.step == len(batches)
    return state.params, losses


def _pairs(got, want, path=""):
    """(path, port leaf, JAX leaf) at the same place of the two trees."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        return [p for k in sorted(want) for p in _pairs(got[k], want[k],
                                                 f"{path}.{k}")]
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        return [p for i, (g, w) in enumerate(zip(got, want))
                for p in _pairs(g, w, f"{path}.{i}")]
    return [(path, got, want)]


def _assert_trained_alike(got, want, init, lr):
    """The port's trained tree against JAX's, in learning rates (see
    LEAF_TOL_*), and both moved from `init` by a tenth of one on average."""
    pairs = _pairs(got, want)
    assert len(pairs) == len(T.tree_leaves(got))
    d = np.concatenate([np.abs(g.detach().numpy() - np.asarray(w)).ravel()
                        for _, g, w in pairs]) / lr
    assert d.max() <= LEAF_TOL_MAX, d.max()
    assert np.quantile(d, 0.999) <= LEAF_TOL_Q, np.quantile(d, 0.999)
    moved = np.concatenate([np.abs(np.asarray(w) - np.asarray(i)).ravel()
                            for (_, _, w), (_, _, i)
                            in zip(pairs, _pairs(got, init))])
    assert moved.mean() >= 0.1 * lr


@pytest.mark.parametrize("b_scale", [0.0, 0.02])
def test_lora_steps_match_jax(b_scale):
    """Three LoRA steps from the same base, adapters and batches: the loss
    of every step and the final A/B against the JAX step with optax's
    adamw + cosine schedule (B = 0 is the init: A's first gradient is 0, so
    its first update is the decay alone)."""
    np_tree, params, jparams = _params(6)
    ad = _numpy_adapters(7, b_scale=b_scale)
    batches = _batches(3)
    scale = 2.0
    jl, jlosses = _run_jax(jparams, jax.tree.map(jnp.asarray, ad), batches,
                           1e-2, 3, lora_scale=scale)
    tl, tlosses = _run_port(params, weights.lora_from_jax(ad), batches,
                            1e-2, 3, lora_scale=scale)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]
    _assert_trained_alike(tl, jl, ad, 1e-2)
    # the base is untouched and took no gradient
    assert torch.equal(params["layers"][0]["wq"],
                       torch.from_numpy(np_tree["layers"][0]["wq"]))
    assert params["layers"][0]["wq"].grad is None


def test_full_finetune_steps_match_jax():
    """Two full-finetune steps: the loss of both and every leaf (embedding
    and norms included: decay on every leaf) against the JAX step."""
    np_tree, params, jparams = _params(8)
    batches = _batches(2, seed=10)
    jp, jlosses = _run_jax(None, jparams, batches, 1e-3, 2)
    tp, tlosses = _run_port(None, params, batches, 1e-3, 2)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    _assert_trained_alike(tp, jp, np_tree, 1e-3)
    assert not torch.equal(tp["final_norm"],
                           torch.from_numpy(np_tree["final_norm"]))


class _Ctx:
    def __init__(self, a, b, needs):
        self.saved_tensors = (a, b)
        self.needs_input_grad = needs


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_mm_f32_backward_is_the_f32_product_derivative(needs):
    """The tied head's f32 product on the card (``aten::mm.dtype``, which
    has no derivative) gets the derivative of the CPU branch's
    ``a.float() @ b.float()``: f32 products rounded to each input's
    dtype."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32)
                         ).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((32, 40)).astype(np.float32)
                         ).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    ga, gb = quant._MmF32.backward(_Ctx(a, b, needs), g)
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    (ar.float() @ br.float()).backward(g)
    for got, want, need in ((ga, ar.grad, needs[0]), (gb, br.grad, needs[1])):
        if need:
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        else:
            assert got is None
    # the forward's call has a meta kernel: the wiring runs on meta tensors
    am = torch.empty((6, 32), dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    bm = torch.empty((32, 40), dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    out = quant._MmF32.apply(am, bm)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert am.grad.shape == am.shape and bm.grad.dtype == torch.bfloat16


def test_step_profile_times_train_steps(capsys):
    """``tools/step_profile --train`` runs the LoRA step it profiles on the
    card; on the CPU it reports the wall alone."""
    from tts_inference_tpu_torch.tools import step_profile

    assert step_profile.main(["--train", "--tiny", "--device", "cpu",
                              "--launches", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["device"], out["batch"], out["len"]) == ("cpu", 2, 48)
    assert len(out["step_wall_ms_all"]) == 2 and out["step_wall_ms"] > 0
    assert step_profile._train_family("nvjet_tst_128x64") == "library matmul"
    assert step_profile._train_family(
        "multi_tensor_apply_kernel") == "optimizer (AdamW)"


# -- CheckpointManager ---------------------------------------------------------


def test_checkpoint_manager_retention_and_restore(tmp_path):
    rng = np.random.default_rng(12)
    trees = {s: {"layers": [{"wq": {"A": torch.from_numpy(
        rng.standard_normal((4, 2)).astype(np.float32)),
        "B": torch.zeros(2, 3, dtype=torch.bfloat16)}}],
        "note": None} for s in (10, 20, 30, 40)}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore_latest()
    for s, tree in trees.items():
        mgr.save(s, tree)
        assert mgr.all_steps() == sorted(trees)[max(0, sorted(trees).index(s)
                                                    - 1):
                                                sorted(trees).index(s) + 1]
    assert sorted(os.listdir(tmp_path / "ck")) == ["30", "40"]
    step, got = mgr.restore_latest()
    assert step == 40 and mgr.latest_step() == 40
    a, b = got["layers"][0]["wq"]["A"], got["layers"][0]["wq"]["B"]
    assert torch.equal(a, trees[40]["layers"][0]["wq"]["A"])
    assert b.dtype == torch.bfloat16 and got["note"] is None
    like = {"layers": [{"wq": {"A": torch.zeros(4, 2, dtype=torch.float64),
                               "B": torch.zeros(2, 3)}}], "note": None}
    _, cast = mgr.restore_latest(like=like)
    assert cast["layers"][0]["wq"]["A"].dtype == torch.float64
    assert cast["layers"][0]["wq"]["B"].dtype == torch.float32
    with pytest.raises(ValueError):
        mgr.restore_latest(like={"layers": []})
    mgr.close()


# -- tools ---------------------------------------------------------------------


def _stream(seed, n_frames, bad=()):
    rng = np.random.default_rng(seed)
    codes = [int(rng.integers(0, 4096)) + 4096 * (i % 7)
             for i in range(7 * n_frames)]
    for i in bad:
        codes[i] += 4096
    return ([jP.TOKEN_SOH, 17, 99, jP.TOKEN_EOT, jP.TOKEN_EOH, jP.TOKEN_SOS]
            + [c + jP.TOKEN_AUDIO_BASE for c in codes] + [jP.TOKEN_EOS])


@pytest.mark.parametrize("bad", [(), (3, 15)])
def test_analyze_tokens_report_equal(bad, tmp_path, capsys):
    ids = _stream(13, 9, bad)
    rep = AT.analyze(ids)
    assert rep == jAT.analyze(ids)
    assert rep["offsets"]["violations"] == len(bad)
    audio = np.sin(np.linspace(0, 50, 4800)).astype(np.float32)
    assert AT.audio_sanity(audio) == jAT.audio_sanity(audio)
    assert AT.audio_sanity(np.zeros(0)) == jAT.audio_sanity(np.zeros(0))
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"token_ids": ids}))
    assert AT.main(["--tokens-json", str(p)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(rep))


def _wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(np.clip(x * 32767, -32768, 32767).astype(
            np.int16).tobytes())


@pytest.mark.parametrize("noise", [0.0, 1e-3, 0.2])
def test_audio_fidelity_report_equal(noise):
    rng = np.random.default_rng(14)
    t = np.arange(12000) / 24000
    a = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(6 * t))
    b = a + noise * rng.standard_normal(a.size)
    assert AF.fidelity_report(a, b) == jAF.fidelity_report(a, b)
    assert AF.THRESHOLDS == jAF.THRESHOLDS
    assert AF.MEL_THRESHOLDS == jAF.MEL_THRESHOLDS


def test_compare_wavs_scales_once(tmp_path):
    """The port compares the waveforms read_wav returns ([-1, 1]); the JAX
    tool divides them by 32767 again, so its mse / max_diff gates pass a
    pair that differs by a sign flip (ROADMAP.md Queue 3)."""
    t = np.arange(6000) / 24000
    a = 0.5 * np.sin(2 * np.pi * 330 * t)
    for name, x in (("a.wav", a), ("b.wav", -a), ("c.wav", 0.999 * a)):
        _wav(tmp_path / name, x)
    pa, pb, pc = (str(tmp_path / n) for n in ("a.wav", "b.wav", "c.wav"))
    ours, theirs = AF.compare_wavs(pa, pb), jAF.compare_wavs(pa, pb)
    assert not ours["checks"]["mse"] and not ours["checks"]["max_diff"]
    assert theirs["checks"]["mse"] and theirs["checks"]["max_diff"]
    assert ours["mse"] == pytest.approx(theirs["mse"] * 32767.0 ** 2,
                                        rel=1e-9)
    assert ours["corr"] == pytest.approx(theirs["corr"], abs=1e-12)
    assert AF.compare_wavs(pa, pc)["pass"]
    assert AF.main([pa, pc]) == 0 and AF.main([pa, pb]) == 1
    (tmp_path / "x").mkdir()
    (tmp_path / "y").mkdir()
    _wav(tmp_path / "x" / "s.wav", a)
    _wav(tmp_path / "y" / "s.wav", 0.999 * a)
    rep = AF.compare_dirs(str(tmp_path / "x"), str(tmp_path / "y"))
    assert rep["pairs"] == 1 and rep["pass"]


# -- imports -------------------------------------------------------------------


def test_training_imports_none_of_the_missing_packages():
    """A GPU host needs no jax, optax, orbax, pyarrow or datasets: the
    training modules and the tools import with all of them (and the JAX
    package) poisoned, and load none of them."""
    mods = [f"tts_inference_tpu_torch.training.{m}" for m in
            ("data", "lora", "train_step", "checkpoint", "finetune")]
    mods += ["tts_inference_tpu_torch.tools.analyze_tokens",
             "tts_inference_tpu_torch.tools.audio_fidelity"]
    bad = ("jax", "optax", "orbax", "pyarrow", "datasets", "tts_inference_tpu")
    code = ("import sys\n"
            f"for b in {bad!r}: sys.modules[b] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v is not None "
            f"and k.split('.')[0] in {bad!r}]\n"
            "assert not loaded, loaded\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
