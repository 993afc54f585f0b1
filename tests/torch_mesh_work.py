"""The port's side of the sharded tests, run on every rank of a gloo pool
(``tests/torch_gloo_pool.py``) or, with ``dp=None``, unsharded in the test
process. Imports torch and the port only (and the numpy weight helpers),
never jax. Each function returns picklable results; ranks outside the mesh
return None."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tests.torch_port_helpers import numpy_llama_tree
from tts_inference_tpu_torch import protocol as P
from tts_inference_tpu_torch import weights
from tts_inference_tpu_torch.config import (MeshConfig, SamplingConfig,
                                            StreamConfig, tiny_config)
from tts_inference_tpu_torch.engine.engine import EngineCore
from tts_inference_tpu_torch.models import llama
from tts_inference_tpu_torch.models.quant import quantize_llama_params
from tts_inference_tpu_torch.ops import sampling as S
from tts_inference_tpu_torch.parallel import collectives as C
from tts_inference_tpu_torch.parallel import lockstep as LS
from tts_inference_tpu_torch.parallel import mesh as M

AUDIO_RANGE = (P.TOKEN_AUDIO_BASE, P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB)
SCFG = StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                    left_context_frames=4)


def _mesh(dp, tp):
    """(member, mesh): every rank takes part in building it; unsharded
    (dp None) is a member with no mesh."""
    if dp is None:
        return True, None
    mesh = M.make_mesh(MeshConfig(dp=dp, tp=tp))
    return mesh is not None, mesh


# int4 group of the sharded tests (a tp-4 row shard cuts it into groups of
# 16)
I4_GROUP = 32


def _params(cfg, seed: int, bits: int = 0, mesh=None, group=I4_GROUP):
    p = weights.llama_params_from_jax(numpy_llama_tree(cfg, seed))
    if bits:
        p = quantize_llama_params(p, bits=bits, group=group)
    return p if mesh is None else weights.shard_params(p, cfg, mesh)


def forward_logits(cfg, tokens, lens, dp=None, tp=None, seed=0):
    """Prefill logits (B, S, V) of the whole batch: each dp rank runs its
    rows of `tokens`, and the rows are gathered over dp."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    p = _params(cfg, seed, mesh=mesh)
    t, ln = torch.from_numpy(tokens), torch.from_numpy(lens)
    local = cfg
    if mesh is not None:
        rows = t.shape[0] // mesh.dp
        r0 = mesh.dp_rank * rows
        t, ln = t[r0:r0 + rows], ln[r0:r0 + rows]
        local = M.local_model_config(cfg, mesh.tp)
    cache = llama.init_kv_cache(local, t.shape[0], 32)
    with torch.no_grad():
        hidden, _ = llama.forward(p, cfg, t, cache,
                                  torch.zeros_like(ln), ln, mesh=mesh)
        logits = llama.compute_logits(p, cfg, hidden, mesh=mesh)
        return C.all_gather_dp(logits, mesh).numpy()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tick(core):
    """Admission of two prompts (+3 decode steps), then a decode launch."""
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), core.batch)
    core.reset_and_seed([0, 1], [1, 2])
    t0, tok, act = core.prefill_decode_launch(
        [[7, 8, 9, 10], [11, 12, 13]], [0, 1], sp,
        np.zeros(core.batch, np.int32), np.zeros(core.batch, bool), n=3)
    t1, _, _ = core.decode_steps_launch(sp, tok, act)
    return np.concatenate([_np(t0), _np(t1)], axis=1)


def _first(core):
    """prefill_slots of one prompt into slot 0, then a decode launch."""
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), core.batch)
    first = core.prefill_slots([[7, 8, 9]], [0], sp)
    active = np.zeros(core.batch, bool)
    active[0] = True
    toks, _, _ = core.decode_steps_launch(sp, first, active)
    return np.concatenate([first[:1, None], _np(toks)[:1]], axis=1)


def _prefix(core):
    """A prefix miss wave, a decode launch, a reset, a prefix hit wave."""
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), core.batch)
    prompts = [[9] * 6 + [7, 8, 9, 10], [9] * 6 + [13, 14]]
    core.reset_and_seed([0, 1], [1, 2])
    t0, tok, act = core.prefill_decode_launch(
        prompts, [0, 1], sp, np.zeros(core.batch, np.int32),
        np.zeros(core.batch, bool), n=3)
    t1, _, _ = core.decode_steps_launch(sp, tok, act)
    core.reset_and_seed([0, 1])
    t2, tok, act = core.prefill_decode_launch(prompts, [0, 1], sp, tok, act,
                                              n=3)
    return np.concatenate([_np(t0)[:2], _np(t1)[:2], _np(t2)[:2]],
                          axis=1), core.prefix_hits


def _paged(core):
    """test_paged_kv / test_int4_kv's engine_tokens: two prompts, seeded,
    with token budgets, then two decode launches."""
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), core.batch)
    core.reset_and_seed([0, 1], [7, 7])
    t0, tok, act = core.prefill_decode_launch(
        [[7, 8, 9, 10], [13, 14]], [0, 1], sp,
        np.zeros(core.batch, np.int32), np.zeros(core.batch, bool), n=3,
        reserve_extra=[24, 24])
    t1, tok, act = core.decode_steps_launch(sp, tok, act)
    t2, _, _ = core.decode_steps_launch(sp, tok, act)
    return np.concatenate([_np(t0), _np(t1), _np(t2)], axis=1)[:2]


SCRIPTS = {"tick": _tick, "first": _first, "prefix": _prefix,
           "paged": _paged}


def engine_run(cfg, ecfg, script, dp=None, tp=None, bits=0, seed=0,
               i4_group=I4_GROUP):
    """One of SCRIPTS over an EngineCore of the numpy weights of `seed`
    (quantized to `bits` when nonzero, int4 at `i4_group`), sharded over
    (dp, tp)."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    core = EngineCore(_params(cfg, seed, bits, mesh, i4_group), cfg, ecfg,
                      eos_id=5, mesh=mesh)
    with torch.no_grad():
        return SCRIPTS[script](core)


def _surface(core, sp=None):
    """The JAX engine's host surface, mirrored under lockstep: seed_slots,
    a fused admission, decode_steps (host arrays), reset_slots, a second
    admission by prefill_slots and decode_steps; greedy (`sp`: the
    sampling parameters of another package's core)."""
    if sp is None:
        sp = S.SamplingParams.from_config(SamplingConfig(greedy=True), 4)
    active = np.array([True, True, False, False])
    core.seed_slots([0, 1], [5, 9])
    t0, tok, act = core.prefill_decode_launch(
        [[7, 8, 9, 10], [11, 12, 13]], [0, 1], sp, np.zeros(4, np.int32),
        np.zeros(4, bool), n=3)
    t1, _, _ = core.decode_steps(sp, tok, act)
    core.reset_slots([0, 1])
    first = core.prefill_slots([[14, 15], [16, 17, 18, 19]], [0, 1], sp)
    t2, _, _ = core.decode_steps(sp, first, active, n=5)
    return np.concatenate([_np(t0), t1, first[:, None], t2], axis=1)[:2]


def warmup_census(cfg, ecfg, dp=None, tp=None, admission_ns=(27, 4)):
    """(the capture names of warmup_graphs, the row buckets) of an
    EngineCore sharded over (dp, tp); on the CPU the census names what the
    card would capture."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    core = EngineCore(_params(cfg, 0, mesh=mesh), cfg, ecfg, eos_id=5,
                      mesh=mesh)
    with torch.no_grad():
        info = core.warmup_graphs(admission_ns=list(admission_ns))
    return sorted(info["graph_census_ms"]), core.row_buckets()


def _host_state(core) -> dict:
    ss = core.sampling_state
    return {"seed": _np(ss.seed), "step": _np(ss.step),
            "len_bounds": core._len_bounds.copy()}


def mirrored_surface(cfg, ecfg, dp=None, tp=None, lport=0, seed=0):
    """``_surface`` on rank 0's core mirrored to the other ranks over the
    lockstep side channel at `lport` (unsharded with dp None). Rank 0
    returns {"tokens", its host state}; a follower {"replayed": the calls
    it replayed, its host state}."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    core = EngineCore(_params(cfg, seed, mesh=mesh), cfg, ecfg, eos_id=5,
                      mesh=mesh)
    with torch.no_grad():
        if mesh is None:
            return {"tokens": _surface(core), **_host_state(core)}
        if mesh.rank:
            sock = LS.follower_channel("127.0.0.1", lport,
                                       process_id=mesh.rank)
            return {"replayed": LS.follower_loop(core, sock),
                    **_host_state(core)}
        mirror = LS.MirroredCore(
            core, LS.coordinator_channel(lport, mesh.world - 1))
        try:
            toks = _surface(mirror)
        finally:
            mirror.close()
        return {"tokens": toks, **_host_state(core)}


def int4_kv_pairs_raise(cfg, ecfg, dp, tp):
    """EngineCore's message when tp does not divide the int4 head pairs."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    try:
        EngineCore(_params(cfg, 0), cfg, ecfg, eos_id=5, mesh=mesh)
    except ValueError as e:
        return str(e)
    return "no error"


def gloo_graphs_raise(cfg, ecfg, dp, tp):
    """A core on a CUDA device over a gloo mesh, graphs asked for: the
    error raised before anything is allocated."""
    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    params = {"final_norm": torch.zeros(1), "layers": []}
    try:
        EngineCore(params, cfg, ecfg, device="cuda", mesh=mesh)
    except ValueError as e:
        return str(e)
    return "no error"


def head_slice(vocab, hidden, tp, seed=0):
    """The vocabulary partition at `tp` (mesh (1, tp)): each rank's
    (text rows, audio rows), the sliced and the whole logits gathered, and
    the embedding lookup of every kind of token summed over tp."""
    member, mesh = _mesh(1, tp)
    if not member:
        return None
    cfg = dataclasses.replace(tiny_config().model, vocab_size=vocab,
                              hidden_size=hidden, num_attention_heads=tp,
                              num_key_value_heads=tp, dtype="float32")
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.standard_normal((vocab, hidden),
                                               dtype=np.float32))
    h = torch.from_numpy(rng.standard_normal((3, hidden), dtype=np.float32))
    shard = M.shard_tree({"embed": emb}, {"embed": ("tp_vocab", None)}, mesh)
    vs = M.vocab_shards(vocab, tp)
    toks = torch.tensor([[0, P.HEAD_SLICE_BASE - 1, P.HEAD_SLICE_BASE,
                          P.TOKEN_AUDIO_BASE + 5, vocab - 1]])
    with torch.no_grad():
        return {"rows": (vs.text[mesh.tp_rank][1], vs.audio[mesh.tp_rank][1]),
                "local_rows": shard["embed"].shape[0],
                "sliced": llama.compute_logits(shard, cfg, h,
                                               P.HEAD_SLICE_BASE,
                                               mesh).numpy(),
                "whole": llama.compute_logits(shard, cfg, h, 0,
                                              mesh).numpy(),
                "embed": llama.embed(shard, cfg, toks, mesh).numpy(),
                "want_sliced": (h @ emb[P.HEAD_SLICE_BASE:].t()).numpy(),
                "want_whole": (h @ emb.t()).numpy(),
                "want_embed": emb[toks].numpy()}


def _requests(specs):
    """Greedy requests: the CPU's kernels round the same sums differently
    at another batch size (a dp rank's rows) or another order of a sum (a
    tp split), so a sampled token can flip where its noise lands at the
    edge of a token's share — the unsharded port flips the same way
    between a batch of 4 and one of 2. A greedy token flips only at a
    top-2 tie."""
    from tts_inference_tpu_torch.engine.scheduler import TTSRequest

    return [TTSRequest(text=text, force_speech=True, stream_cfg=SCFG,
                       sampling=SamplingConfig(max_tokens=n, seed=seed,
                                               greedy=True,
                                               token_range=AUDIO_RANGE))
            for text, seed, n in specs]


def _drain(req, timeout=300):
    chunks = []
    while True:
        kind, payload = req.events.get(timeout=timeout)
        if kind == "chunk":
            chunks.append(payload.pcm)
        elif kind == "done":
            return b"".join(chunks), payload
        else:
            raise AssertionError(payload)


def scheduler_run(specs, dp=None, tp=None, lport=0, admission_steps=None,
                  seed=0, engine=None, stagger=False):
    """Stream `specs` [(text, seed, max_tokens)] through a Scheduler over
    the tiny runtime's weights of `seed` (`engine`: EngineConfig fields
    over tiny_config's; `stagger`: one step between the first request and
    the others): unsharded, or sharded with the scheduler on rank 0 and its
    core mirrored to the other ranks over the lockstep side channel at
    `lport`. Rank 0 returns {"streams": [(pcm, token ids, first decode
    ms)] per request (the first is 0.0 where the fused admission vocode
    emitted the first chunk), "preemptions": n}; followers return their
    replayed call count."""
    from tts_inference_tpu_torch.engine import scheduler as SC
    from tts_inference_tpu_torch.engine.scheduler import Scheduler
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    cfg = tiny_config()
    if engine:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, **engine))
    params = weights.init_llama_params(cfg.model, seed)
    if mesh is not None:
        params = weights.shard_params(params, cfg.model, mesh)
        if mesh.rank:
            sock = LS.follower_channel("127.0.0.1", lport,
                                       process_id=mesh.rank)
            core = EngineCore(params, cfg.model, cfg.engine,
                              eos_id=P.TOKEN_EOS, seed=seed, mesh=mesh)
            return LS.follower_loop(core, sock)
    mirrors = []

    def wrap(core):
        socks = LS.coordinator_channel(lport, mesh.world - 1)
        mirrors.append(LS.MirroredCore(core, socks))
        return mirrors[0]

    voc = SnacDecoder(weights.init_snac_params(cfg.snac, seed + 1), cfg.snac)
    s = Scheduler(params, cfg, voc, ByteTokenizer(), seed=seed, mesh=mesh,
                  wrap_core=wrap if mesh is not None else None)
    if admission_steps:
        s.admission_steps = admission_steps
    reqs = _requests(specs)
    tokens = {}
    finish = SC._SlotState.finish

    def keep(state):      # a stream's raw token ids, at its finish
        tokens[state.req.id] = list(state.token_ids)
        finish(state)

    SC._SlotState.finish = keep
    try:
        with torch.no_grad():
            for i, r in enumerate(reqs):
                s.submit(r)
                if stagger and i == 0:
                    s.step()      # the first is admitted alone: the oldest
            for _ in range(4000):
                if not s.step() and s.n_queued == 0:
                    break
        s.drain_vocoder()
    finally:
        SC._SlotState.finish = finish
    out = []
    for r in reqs:
        pcm, m = _drain(r)
        out.append((pcm, tokens[r.id], m.decode_times_ms[:1]))
    s.stop()
    for m in mirrors:
        m.close()
    return {"streams": out, "preemptions": s.preemptions}



# ---- sharded training -------------------------------------------------------


def numpy_adapters(cfg, seed, r=4, b_scale=0.02):
    """Adapters in the JAX package's layout (numpy f32): A and B drawn from
    `seed` (B nonzero, so A takes a gradient from the first step)."""
    from tts_inference_tpu_torch.training.lora import DEFAULT_TARGETS

    rng = np.random.default_rng(seed)
    tree = numpy_llama_tree(cfg)
    return {"layers": [{t: {
        "A": (rng.standard_normal((lp[t].shape[0], r)) / 2).astype(
            np.float32),
        "B": (b_scale * rng.standard_normal((r, lp[t].shape[1]))).astype(
            np.float32)} for t in DEFAULT_TARGETS}
        for lp in tree["layers"]]}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().float().numpy()


def train_run(cfg, batches, dp=None, tp=None, full=False, lr=1e-2, seed=0,
              adapters=None):
    """The port's train step over `batches` [(tokens, lens)] from the numpy
    weights of `seed`: a LoRA step over the numpy `adapters` (default:
    numpy_adapters(cfg, seed + 1)), or a full fine-tune; unsharded, or on
    (dp, tp) with every rank passing the whole batch. Returns each step's
    loss, and the trained tree and the last step's gradients (summed as
    the step sums them), gathered whole."""
    from tts_inference_tpu_torch.training import train_step as T

    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    base = _params(cfg, seed, mesh=mesh)
    if full:
        trainable, base_params = base, None
    else:
        lora = weights.lora_from_jax(adapters or numpy_adapters(cfg,
                                                                seed + 1))
        trainable = lora if mesh is None else weights.shard_lora(lora, cfg,
                                                                 mesh)
        base_params = base
    opt = T.make_optimizer(lr, len(batches))
    step = T.make_train_step(cfg, opt, base_params=base_params,
                             lora_scale=2.0, mesh=mesh)
    state = T.init_train_state(trainable, opt)
    losses = []
    for tokens, lens in batches:
        state, loss = step(state, tokens, lens)
        losses.append(float(loss))
    tree, grads = state.params, _grad_tree(state.params)
    if mesh is not None:
        with torch.no_grad():
            gather = (weights.gather_params if full else weights.gather_lora)
            tree, grads = (gather(t, cfg, mesh) for t in (tree, grads))
    return {"losses": losses, "tree": _to_numpy(tree),
            "grads": _to_numpy(grads)}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def lora_init_cut(cfg, dp, tp, seed=3):
    """init_lora(mesh=) on this rank's shard of the base, against the cut
    of the unsharded init_lora from the same generator seed."""
    from tts_inference_tpu_torch.training import lora as L

    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    whole = L.init_lora(torch.Generator().manual_seed(seed), cfg,
                        _params(cfg, 0), r=4)
    got = L.init_lora(torch.Generator().manual_seed(seed), cfg,
                      _params(cfg, 0, mesh=mesh), r=4, mesh=mesh)
    want = weights.shard_lora(whole, cfg, mesh)
    return all(torch.equal(a, b) for a, b in zip(
        _leaves(got), _leaves(want))) and len(_leaves(got)) == len(
        _leaves(whole))


def _leaves(tree):
    from tts_inference_tpu_torch.training.train_step import tree_leaves

    return tree_leaves(tree)


def vocab_loss(vocab, hidden, tp, seed=0):
    """The vocab-parallel nll on a (1, tp) mesh against log_softmax of the
    whole logits: values, and the gradients of the hidden states and of
    the embedding (this rank's block, gathered whole); and those gradients
    through the logits gathered over tp."""
    from tts_inference_tpu_torch.training import train_step as T

    member, mesh = _mesh(1, tp)
    if not member:
        return None
    cfg = dataclasses.replace(tiny_config().model, vocab_size=vocab,
                              hidden_size=hidden, num_attention_heads=tp,
                              num_key_value_heads=tp, dtype="float32")
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.standard_normal((vocab, hidden),
                                               dtype=np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, hidden),
                                              dtype=np.float32))
    tg = torch.tensor([[0, P.HEAD_SLICE_BASE - 1, P.HEAD_SLICE_BASE],
                       [P.TOKEN_AUDIO_BASE + 5, vocab - 1, 17]]) % vocab
    shard = M.shard_tree({"embed": emb}, {"embed": ("tp_vocab", None)}, mesh)
    shard["embed"].requires_grad_(True)
    h = h0.clone().requires_grad_(True)
    weight = torch.arange(1, 7.0).view(2, 3)
    nll = T.vocab_parallel_nll(shard, cfg, h, tg, mesh)
    (nll * weight).sum().backward()
    vs = M.vocab_shards(vocab, tp)
    g_emb = M.gather_tree(shard["embed"].grad, ("tp_vocab", None), mesh,
                          vocab=vs)
    # the same through the gathered logits (gather_from_tp's backward)
    shard["embed"].grad = None
    hg = h0.clone().requires_grad_(True)
    gathered = -torch.log_softmax(llama.compute_logits(shard, cfg, hg,
                                                       mesh=mesh), -1)
    (gathered.gather(-1, tg[..., None])[..., 0] * weight).sum().backward()
    g_emb_gathered = M.gather_tree(shard["embed"].grad, ("tp_vocab", None),
                                   mesh, vocab=vs)
    emb.requires_grad_(True)
    h1 = h0.clone().requires_grad_(True)
    want = -torch.log_softmax(h1 @ emb.t(), -1).gather(
        -1, tg[..., None])[..., 0]
    (want * weight).sum().backward()
    return {"nll": nll.detach().numpy(), "want": want.detach().numpy(),
            "g_h": h.grad.numpy(), "want_g_h": h1.grad.numpy(),
            "g_emb": g_emb.numpy(), "want_g_emb": emb.grad.numpy(),
            "g_h_gathered": hg.grad.numpy(),
            "g_emb_gathered": g_emb_gathered.numpy()}


def int4_cut_rows(k, n, group, tp):
    """Each tp rank's row shard of an int4 (k, n) matrix of `group`,
    dequantized, against the rows of the whole matrix it holds (bit
    equality), with the shard's group; and the whole gathered back."""
    from tts_inference_tpu_torch.models.quant import (QuantLinearI4,
                                                      quantize_linear_i4)
    from tts_inference_tpu_torch.ops.int4_matmul import unpack_int4

    member, mesh = _mesh(1, tp)
    if not member:
        return None

    def deq(w):
        kk = w.w_p.shape[0] * 2
        g = kk // w.scale.shape[0]
        q = unpack_int4(w.w_p)[:, :w.scale.shape[1]].float()
        return (q.reshape(kk // g, g, -1) * w.scale[:, None]).reshape(kk, -1)

    rng = np.random.default_rng(k + n + group)
    w = quantize_linear_i4(torch.from_numpy(
        rng.standard_normal((k, n), dtype=np.float32)), group)
    spec = QuantLinearI4(w_p=("tp", None), scale=(None, None))
    shard = M.shard_tree(w, spec, mesh)
    kl = k // tp
    rows = deq(w)[mesh.tp_rank * kl:(mesh.tp_rank + 1) * kl]
    back = M.gather_tree(shard, spec, mesh, i4_group=group)
    return {"equal": bool(torch.equal(deq(shard), rows)),
            "group": kl // shard.scale.shape[0],
            "back": bool(torch.equal(back.w_p, w.w_p)
                         and torch.equal(back.scale, w.scale))}


def merge_cut(cfg, dp, tp, seed=4):
    """merge_params on this rank's shards of the base and the adapters
    against the cut of the whole merge: the max abs difference."""
    from tts_inference_tpu_torch.training import lora as L

    member, mesh = _mesh(dp, tp)
    if not member:
        return None
    whole = _params(cfg, 0)
    lora = weights.lora_from_jax(numpy_adapters(cfg, seed))
    want = weights.shard_params(L.merge_params(whole, lora, 2.0), cfg, mesh)
    got = L.merge_params(weights.shard_params(whole, cfg, mesh),
                         weights.shard_lora(lora, cfg, mesh), 2.0)
    return max(float((a - b).abs().max())
               for a, b in zip(_leaves(got), _leaves(want)))
