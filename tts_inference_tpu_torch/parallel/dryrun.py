"""Multi-process dry run of sharded serving on the CPU.

    python -m tts_inference_tpu_torch.parallel.dryrun 4

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
It starts n gloo processes on the CPU over localhost, lays a (dp, tp) mesh
over them (tp 4 when 4 divides n, else 2 when 2 does, else 1) and checks,
on every rank, that

0. one full LoRA training step over the mesh (batch 2·dp × 32, r 4, the
   adapters drawn from a seed and cut; ``training/train_step.py``) gives
   the unsharded step's loss and, gathered, its adapters;
1. a sharded serving tick — an EngineCore admission (prefill + 3 decode
   steps) and a decode launch over a 4-head-per-tp model — gives the
   unsharded core's tokens;
2. the production serving configuration — paged int8 KV with on-demand
   growth, through the continuous-batching Scheduler on process 0 with its
   core mirrored to the others (``parallel/lockstep.py``) — streams the
   unsharded scheduler's audio bytes and token count.

Process 0 prints one JSON line; a failed check raises (nonzero exit).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run over n gloo processes; returns process 0's line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    ports = [str(_free_port()), str(_free_port())]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tts_inference_tpu_torch.parallel.dryrun",
         "--impl", str(n_devices), str(r), *ports],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_devices)]
    outs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip rank {r} failed "
                               f"rc={p.returncode}:\n{err[-4000:]}")
    line = outs[0][0].strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def train_check(model_cfg, params, mesh, lr: float = 1e-4) -> dict:
    """One LoRA step (r 4, adapters from seed 1) on a batch of 2·dp × 32
    tokens from seed 0, over `mesh` and unsharded on this rank: the loss
    within 1e-5 and the gathered adapters within 2·lr — one Adam step
    moves an element by at most lr, and where an element's gradient is at
    f32 rounding level its direction is the noise's."""
    import torch

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T

    rng = np.random.default_rng(0)
    batch = 2 * mesh.dp
    tokens = rng.integers(0, model_cfg.vocab_size, size=(batch, 32))
    lens = np.full((batch,), 32, np.int32)

    def step(base, m):
        lora = L.init_lora(torch.Generator().manual_seed(1), model_cfg,
                           base, r=4, mesh=m)
        opt = T.make_optimizer(lr, 1)
        state = T.init_train_state(lora, opt)
        fn = T.make_train_step(model_cfg, opt, base_params=base, mesh=m)
        state, loss = fn(state, tokens.astype(np.int32), lens)
        out = state.params
        if m is not None:
            with torch.no_grad():
                out = weights.gather_lora(out, model_cfg, m)
        return float(loss), T.tree_leaves(out)

    loss, got = step(weights.shard_params(params, model_cfg, mesh), mesh)
    want_loss, want = step(params, None)
    diff = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not (np.isfinite(loss) and abs(loss - want_loss) <= 1e-5 * want_loss
            and len(got) == len(want) and diff <= 2 * lr):
        raise AssertionError(f"sharded LoRA step diverged: loss {loss} vs "
                             f"{want_loss}, adapters {diff}")
    return {"loss": loss, "loss_unsharded": want_loss,
            "adapter_max_diff": diff,
            "adapter_leaves": len(got)}


def _impl(n: int, rank: int, port: int, lport: int) -> None:
    import torch

    from tts_inference_tpu_torch import protocol as P
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import (EngineConfig, MeshConfig,
                                                ModelConfig, SamplingConfig,
                                                StreamConfig, tiny_config)
    from tts_inference_tpu_torch.engine.engine import EngineCore
    from tts_inference_tpu_torch.engine.scheduler import Scheduler, TTSRequest
    from tts_inference_tpu_torch.models.snac import SnacDecoder
    from tts_inference_tpu_torch.ops import sampling as S
    from tts_inference_tpu_torch.parallel import lockstep as LS
    from tts_inference_tpu_torch.parallel import mesh as M
    from tts_inference_tpu_torch.parallel.multihost import (init_multihost,
                                                            is_coordinator)
    from tts_inference_tpu_torch.utils.tokenizer import ByteTokenizer

    torch.set_num_threads(1)
    tp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = n // tp
    init_multihost(f"127.0.0.1:{port}", n, rank, device="cpu")
    mesh = M.make_mesh(MeshConfig(dp=dp, tp=tp))

    model_cfg = ModelConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=max(4, tp), head_dim=16,
        rope_scaling_factor=None, max_position_embeddings=256,
        dtype="float32")
    params = weights.init_llama_params(model_cfg, 0)

    # ---- 0) a LoRA training step against the unsharded step ---------------
    train = train_check(model_cfg, params, mesh)

    # ---- 1) a sharded serving tick against the unsharded core -------------
    ecfg = EngineConfig(max_batch_size=2 * dp, max_input_len=32,
                        max_output_len=96, prefill_buckets=(16, 32),
                        kv_buckets=(32, 64), decode_steps_per_call=4)
    sp = S.SamplingParams.from_config(SamplingConfig(greedy=True),
                                      ecfg.max_batch_size)
    prompts = [[7, 8, 9, 10], [11, 12, 13]]

    def serve_tick(core):
        core.reset_and_seed([0, 1], [1, 2])
        toks0, tok, act = core.prefill_decode_launch(
            prompts, [0, 1], sp, np.zeros(core.batch, np.int32),
            np.zeros(core.batch, bool), n=3)
        toks1, _, _ = core.decode_steps_launch(sp, tok, act)
        return np.concatenate([toks0.numpy()[:2], toks1.numpy()[:2]], 1)

    want = serve_tick(EngineCore(params, model_cfg, ecfg, eos_id=5))
    got = serve_tick(EngineCore(weights.shard_params(params, model_cfg,
                                                     mesh),
                                model_cfg, ecfg, eos_id=5, mesh=mesh))
    if not np.array_equal(got, want):
        raise AssertionError(f"sharded serving tick diverged:\n{got}\nvs\n"
                             f"{want}")

    # ---- 2) paged int8 on demand through the mirrored scheduler ------------
    tcfg = tiny_config()
    if tcfg.model.num_key_value_heads % tp:
        # the tiny model has 2 KV heads: a tp 4 mesh gets one per rank (the
        # same widening the JAX dry run makes, on both legs)
        tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, num_key_value_heads=tp))
    tcfg = dataclasses.replace(tcfg, engine=dataclasses.replace(
        tcfg.engine, max_batch_size=2 * dp, paged_kv=True,
        kv_cache_int8=True, kv_on_demand=True, kv_block_size=32,
        kv_pool_tokens=2 * dp * 320, resume_buckets=(128,),
        decode_steps_per_call=4), mesh=MeshConfig(dp=dp, tp=tp))
    tparams = weights.init_llama_params(tcfg.model, 3)
    shard = weights.shard_params(tparams, tcfg.model, mesh)
    host = "127.0.0.1"
    if not is_coordinator():
        sock = LS.follower_channel(host, lport, process_id=rank)
        core = EngineCore(shard, tcfg.model, tcfg.engine,
                          eos_id=P.TOKEN_EOS, mesh=mesh)
        LS.follower_loop(core, sock)
        return
    voc = SnacDecoder(weights.init_snac_params(tcfg.snac, 4), tcfg.snac)
    socks = LS.coordinator_channel(lport, n - 1, bind=host)

    def sched_tick(p, m=None, wrap=None):
        sched = Scheduler(p, tcfg, voc, ByteTokenizer(), mesh=m,
                          wrap_core=wrap)
        req = TTSRequest(
            text="dryrun", force_speech=True,
            sampling=SamplingConfig(
                max_tokens=24, seed=11, temperature=0.8,
                token_range=(P.TOKEN_AUDIO_BASE,
                             P.TOKEN_AUDIO_BASE + P.AUDIO_VOCAB)),
            stream_cfg=StreamConfig(frames_per_chunk=2, lookahead_frames=3,
                                    left_context_frames=4))
        sched.submit(req)
        for _ in range(400):
            if not sched.step() and sched.n_queued == 0 \
                    and not sched.n_active:
                break
        sched.drain_vocoder()
        pcm, toks = b"", None
        while True:
            kind, payload = req.events.get(timeout=60)
            if kind == "chunk":
                pcm += payload.pcm
            elif kind == "done":
                toks = payload.tokens
                break
            else:
                raise RuntimeError(payload)
        sched.stop()
        return pcm, toks

    mirrors = []

    def wrap(core):
        mirrors.append(LS.MirroredCore(core, socks))
        return mirrors[0]

    pcm_mesh, ntok_mesh = sched_tick(shard, mesh, wrap)
    mirrors[0].close()
    pcm_ref, ntok_ref = sched_tick(tparams)
    if not (ntok_ref == ntok_mesh == 24 and pcm_ref == pcm_mesh):
        raise AssertionError("sharded paged-int8 scheduler tick diverged "
                             f"(tokens {ntok_mesh} vs {ntok_ref})")
    print(json.dumps({"dryrun_multichip": n, "dp": dp, "tp": tp,
                      "train": train,
                      "serve_tick_tokens": int(got.size),
                      "scheduler_tokens": ntok_mesh,
                      "scheduler_pcm_bytes": len(pcm_mesh), "ok": True}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--impl"]:
        _impl(*map(int, sys.argv[2:6]))
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
