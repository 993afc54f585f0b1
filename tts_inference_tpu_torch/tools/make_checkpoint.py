"""Write the port's weights out as the checkpoint directories a user boots
from: an HF Llama dir (sharded safetensors + index + ``config.json``), a
SNAC dir (``config.json`` + ``pytorch_model.bin`` in the snac package's key
layout, weight-normed convolutions as ``weight_g`` / ``weight_v``) and a
byte-level BPE ``tokenizer.json`` trained here in pure Python. torch, numpy
and the standard library only.

    python -m tts_inference_tpu_torch.tools.make_checkpoint --out DIR \\
        [--tiny] [--seed 0] [--device cpu]

writes ``DIR/model`` (with the tokenizer) and ``DIR/snac`` from the seeded
random weights ``cli serve`` builds (LM seed, vocoder seed + 1); then

    python -m tts_inference_tpu_torch.cli serve --model-path DIR/model \\
        --snac-path DIR/snac
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from tts_inference_tpu_torch.config import ModelConfig, SnacConfig
from tts_inference_tpu_torch.utils import safetensors_io
from tts_inference_tpu_torch.utils.tokenizer import (_BYTE_CHAR,
                                                     _PreTokenizer)

# -- llama -------------------------------------------------------------------


_LAYER_NAMES = (("input_norm", "input_layernorm", False),
                ("post_attn_norm", "post_attention_layernorm", False),
                ("wq", "self_attn.q_proj", True),
                ("wk", "self_attn.k_proj", True),
                ("wv", "self_attn.v_proj", True),
                ("wo", "self_attn.o_proj", True),
                ("w_gate", "mlp.gate_proj", True),
                ("w_up", "mlp.up_proj", True),
                ("w_down", "mlp.down_proj", True))


def _hf_tensors(params: Dict, cfg: ModelConfig):
    """(HF name, tensor in HF layout) in the order HF checkpoints list them;
    linears go back from the port's (in, out) to HF's (out, in)."""

    def full(name, w, linear=False):
        if not isinstance(w, torch.Tensor):
            raise TypeError(f"{name} is {type(w).__name__}: a quantized tree "
                            "is saved by cli quantize")
        return name, (w.t() if linear else w)

    yield full("model.embed_tokens.weight", params["embed"])
    for i, lp in enumerate(params["layers"]):
        for key, name, linear in _LAYER_NAMES:
            yield full(f"model.layers.{i}.{name}.weight", lp[key], linear)
    yield full("model.norm.weight", params["final_norm"])
    if "lm_head" in params and not cfg.tie_word_embeddings:
        yield full("lm_head.weight", params["lm_head"], True)


def hf_config_dict(cfg: ModelConfig) -> dict:
    """The ``config.json`` of an HF LlamaForCausalLM with `cfg`'s geometry."""
    rs = None
    if cfg.rope_scaling_factor:
        rs = {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
              "low_freq_factor": cfg.rope_low_freq_factor,
              "high_freq_factor": cfg.rope_high_freq_factor,
              "original_max_position_embeddings":
                  cfg.rope_original_max_position}
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": rs,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": cfg.dtype,
    }


def write_llama_checkpoint(params: Dict, cfg: ModelConfig, out: str,
                           shard_bytes: int = 2 << 30) -> Dict:
    """Write the port's tensor tree as an HF LlamaForCausalLM dir: shards of
    at most `shard_bytes` (a tensor larger than that gets a shard of its
    own), ``model-0000i-of-0000n.safetensors``, the index json and
    ``config.json``. The host holds one shard at a time."""
    os.makedirs(out, exist_ok=True)
    shards: List[List[str]] = [[]]
    size = 0
    tensors = dict(_hf_tensors(params, cfg))
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if size and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    weight_map, total = {}, 0
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        host = {k: tensors[k].contiguous().cpu() for k in names}
        total += safetensors_io.write_file(os.path.join(out, fname), host,
                                           metadata={"format": "pt"})
        del host
        weight_map.update({k: fname for k in names})
    with open(os.path.join(out, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    return {"out": out, "shards": len(shards), "bytes": total,
            "tensors": len(tensors)}


# -- snac --------------------------------------------------------------------


def _weight_norm(sd: Dict, prefix: str, w: torch.Tensor) -> None:
    """``weight_v`` = w and ``weight_g`` = its norm over all dims but 0,
    by the fold's own numpy expression: folding gives w back bit-equal."""
    v = w.detach().cpu().float().numpy()
    axes = tuple(range(1, v.ndim))
    g = np.sqrt((v * v).sum(axis=axes, keepdims=True))
    sd[f"{prefix}.weight_g"] = torch.from_numpy(g)
    sd[f"{prefix}.weight_v"] = torch.from_numpy(v.copy())


def snac_state_dict(params: Dict, cfg: SnacConfig) -> Dict[str, torch.Tensor]:
    """The port's vocoder tree → the snac package's state-dict keys
    (decoder and quantizer codebooks / out_proj; what ``load_snac_torch_state``
    reads)."""
    sd: Dict[str, torch.Tensor] = {}

    def host(t):
        return t.detach().to("cpu", torch.float32).clone()

    def conv(prefix, p):
        _weight_norm(sd, prefix, p["w"])
        if p.get("b") is not None:
            sd[f"{prefix}.bias"] = host(p["b"])

    def alpha(prefix, a):
        sd[f"{prefix}.alpha"] = host(a).reshape(1, -1, 1)

    for i, q in enumerate(params["quantizer"]):
        base = f"quantizer.quantizers.{i}"
        sd[f"{base}.codebook.weight"] = host(q["codebook"])
        conv(f"{base}.out_proj", q["out_proj"])
    dp = params["decoder"]
    base = "decoder.model"
    if cfg.depthwise:
        conv(f"{base}.0", dp["in"]["dw"])
        conv(f"{base}.1", dp["in"]["pw"])
        block0 = 2
    else:
        conv(f"{base}.0", dp["in"]["conv"])
        block0 = 1
    for i, bp in enumerate(dp["blocks"]):
        blk = f"{base}.{block0 + i}.block"
        alpha(f"{blk}.0", bp["alpha"])
        conv(f"{blk}.1", bp["up"])
        if bp["noise_lin"] is not None:
            _weight_norm(sd, f"{blk}.2.linear", bp["noise_lin"]["w"])
        for j, rp in zip((3, 4, 5), bp["res"]):
            r = f"{blk}.{j}.block"
            alpha(f"{r}.0", rp["alpha1"])
            conv(f"{r}.1", rp["conv1"])
            alpha(f"{r}.2", rp["alpha2"])
            conv(f"{r}.3", rp["conv2"])
    n_out = block0 + len(dp["blocks"])
    alpha(f"{base}.{n_out}", dp["out_alpha"])
    conv(f"{base}.{n_out + 1}", dp["out_conv"])
    return sd


def write_snac_checkpoint(params: Dict, cfg: SnacConfig, out: str) -> Dict:
    """``config.json`` (the snac package's keys) + ``pytorch_model.bin``."""
    os.makedirs(out, exist_ok=True)
    sd = snac_state_dict(params, cfg)
    torch.save(sd, os.path.join(out, "pytorch_model.bin"))
    enc_rates = [2, 4, 8, 8]
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({
            "sampling_rate": cfg.sampling_rate,
            "encoder_dim": cfg.latent_dim // 2 ** len(enc_rates),
            "encoder_rates": enc_rates,
            "latent_dim": cfg.latent_dim,
            "decoder_dim": cfg.decoder_dim,
            "decoder_rates": list(cfg.decoder_rates),
            "attn_window_size": None,
            "codebook_size": cfg.codebook_size,
            "codebook_dim": cfg.codebook_dim,
            "vq_strides": list(cfg.vq_strides),
            "noise": cfg.noise,
            "depthwise": cfg.depthwise,
        }, f, indent=2)
    return {"out": out, "tensors": len(sd),
            "bytes": sum(t.numel() * t.element_size() for t in sd.values())}


# -- tokenizer ---------------------------------------------------------------

# English shaped like TTS traffic, voice-prefixed as the serving wire format
# sends it ("{voice}: {text}")
_SENTENCES = [
    "Hello there, how are you doing today?",
    "The quick brown fox jumps over the lazy dog.",
    "Please speak this sentence aloud in a natural voice.",
    "Streaming text to speech with low latency is the goal.",
    "This is a short test of the emergency broadcast system.",
    "Numbers like one, two, three, and four are common.",
    "We will measure the time to first audio very carefully.",
    "Stream 0: the quick brown fox jumps over the dog.",
    "Thank you for calling; your order will arrive on Tuesday.",
    "Could you read the next paragraph a little more slowly?",
    "The weather today is sunny with a light breeze from the west.",
    "I'm sorry, I didn't catch that. Could you say it again?",
]
_VOICES = ["tara", "zac", "zoe", "jess", "leo", "mia", "julia", "leah"]


def _corpus() -> Iterable[str]:
    for t in _SENTENCES:
        yield t
        for v in _VOICES:
            yield f"{v}: {t}"


def train_bpe(corpus: Iterable[str], merges: int = 400):
    """A byte-level BPE trained by pair counts: (vocab, merges). The
    vocab starts with the 256 byte characters; each step merges the most
    frequent adjacent pair (ties: the smallest pair)."""
    pre = _PreTokenizer({"type": "ByteLevel", "add_prefix_space": False,
                         "use_regex": True})
    counts = Counter(w for text in corpus for w in pre(text))
    vocab = {c: i for i, c in enumerate(sorted(_BYTE_CHAR.values()))}
    words = {w: list(w) for w in counts}
    out = []
    for _ in range(merges):
        pairs: Counter = Counter()
        for w, syms in words.items():
            for p in zip(syms, syms[1:]):
                pairs[p] += counts[w]
        if not pairs:
            break
        (a, b), _n = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))
        new = a + b
        vocab.setdefault(new, len(vocab))
        out.append([a, b])
        for w, syms in words.items():
            i, merged = 0, []
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    merged.append(new)
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            words[w] = merged
    return vocab, out


def write_tokenizer(out: str, merges: int = 400,
                    corpus: Optional[Iterable[str]] = None) -> str:
    """Train and write a byte-level BPE ``tokenizer.json`` and
    ``tokenizer_config.json`` (the layout ``tokenizers`` saves); returns
    `out`. Every id stays far below the protocol's special range."""
    vocab, merge_list = train_bpe(corpus or _corpus(), merges)
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": True}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [], "normalizer": None,
        "pre_tokenizer": byte_level, "post_processor": None,
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merge_list},
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "model_max_length": 131072,
                   "clean_up_tokenization_spaces": False}, f, indent=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_config() geometry (tests, CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the seeded weights are drawn (default: cuda, "
                         "as `cli serve` draws them; an error when there is "
                         "none — ask for the CPU with --device cpu, which "
                         "draws other numbers)")
    ap.add_argument("--shard-mb", type=int, default=2048)
    args = ap.parse_args(argv)
    from tts_inference_tpu_torch import weights
    from tts_inference_tpu_torch.config import Config, tiny_config
    from tts_inference_tpu_torch.runtime import default_device

    cfg = tiny_config() if args.tiny else Config()
    dev = args.device or default_device()
    t0 = time.perf_counter()
    params = weights.init_llama_params(cfg.model, args.seed, dev)
    info = {"model": write_llama_checkpoint(
        params, cfg.model, os.path.join(args.out, "model"),
        shard_bytes=args.shard_mb << 20)}
    del params
    write_tokenizer(os.path.join(args.out, "model"))
    vparams = weights.init_snac_params(cfg.snac, args.seed + 1, dev)
    info["snac"] = write_snac_checkpoint(vparams, cfg.snac,
                                         os.path.join(args.out, "snac"))
    info["model_config"] = dataclasses.asdict(cfg.model)
    info["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
