"""Subprocess driver for tests/test_torch_multihost.py, the port's twin of
tests/multihost_driver.py.

Each child joins the default torch.distributed group (gloo over
localhost: the stand-in for hosts on a network), lays the global (dp, tp)
mesh over every process (``parallel.multihost.make_global_mesh``, one
device a process, tp inside a host) and runs ``compute``: a LoRA train
step and a prefill digest. The parent runs the same computation in one
process, unsharded: several processes must be a pure performance
transform. Imports torch and the port only.
"""

from __future__ import annotations

import sys

import numpy as np


def compute(mesh=None, dp: int = 1):
    """(loss, digest): one LoRA train step (r 4, adapters from seed 1,
    AdamW at 1e-4) and the sum of squares of the prefill logits, on a batch
    of 2·dp × 32 tokens from seed 0, over `mesh` (None: unsharded, with the
    batch of a mesh of `dp`)."""
    import torch

    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import ModelConfig
    from tts_inference_tpu_torch.models import llama
    from tts_inference_tpu_torch.parallel import collectives as C
    from tts_inference_tpu_torch.parallel import mesh as M
    from tts_inference_tpu_torch.training import lora as L
    from tts_inference_tpu_torch.training import train_step as T

    dp, tp = (mesh.dp, mesh.tp) if mesh is not None else (dp, 1)
    cfg = ModelConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=max(4, tp), head_dim=16,
        rope_scaling_factor=None, max_position_embeddings=256,
        dtype="float32")
    params = weights.init_llama_params(cfg, 0)
    if mesh is not None:
        params = weights.shard_params(params, cfg, mesh)
    rng = np.random.default_rng(0)
    batch, seq = 2 * dp, 32
    tokens = rng.integers(0, 512, size=(batch, seq)).astype(np.int32)
    lens = np.full((batch,), seq, np.int32)

    # (a) the LoRA train step: gradients summed over dp, across processes
    lora = L.init_lora(torch.Generator().manual_seed(1), cfg, params, r=4,
                       mesh=mesh)
    opt = T.make_optimizer(1e-4, 1)
    state = T.init_train_state(lora, opt)
    step = T.make_train_step(cfg, opt, base_params=params, mesh=mesh)
    _, loss = step(state, tokens, lens)

    # (b) the prefill digest: each dp rank's rows through the serving
    # forward, the sum of squares summed over dp
    t, ln = torch.from_numpy(tokens), torch.from_numpy(lens)
    local = cfg
    if mesh is not None:
        t = M.shard_tree(t, M.batch_pspec(), mesh)
        ln = M.shard_tree(ln, M.batch_pspec()[:1], mesh)
        local = M.local_model_config(cfg, mesh.tp)
    cache = llama.init_kv_cache(local, t.shape[0], 64)
    with torch.no_grad():
        logits, _ = llama.prefill(params, cfg, t, ln, cache, mesh=mesh)
        digest = C.all_reduce_dp((logits.float() ** 2).sum(), mesh)
    return float(loss), float(digest)


def main() -> None:
    import torch

    from tts_inference_tpu_torch.parallel.multihost import (init_multihost,
                                                            make_global_mesh)

    pid, nproc, port, tp = (int(a) for a in sys.argv[1:5])
    torch.set_num_threads(1)
    init_multihost(f"127.0.0.1:{port}", nproc, pid, device="cpu")
    mesh = make_global_mesh(tp=tp)
    loss, digest = compute(mesh)
    print(f"MHOK pid={pid} dp={mesh.dp} tp={mesh.tp} loss={loss!r} "
          f"digest={digest!r}", flush=True)


if __name__ == "__main__":
    main()
