"""The run's weights, made on the device from the seed in a few large
calls, and handed to both the port and the reference.

The LM: each of the seven per-layer matrices of every layer in one
bf16 `randn` (scaled by 1/sqrt(fan_in)), the embedding and the head in one
each, norms at one. The SNAC decoder: one uniform and one normal draw
carved into its tensors (the port's torch layouts), alphas one, biases
zero. Every tensor of a kind is a view of one buffer."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SNAC = {"latent_dim": 768, "decoder_dim": 1024, "rates": (8, 8, 4, 2),
        "codebook_size": 4096, "codebook_dim": 8, "strides": (4, 2, 1)}


def dims(cfg: Dict) -> Tuple[int, int, int, int, int, int]:
    h, nq = cfg["hidden_size"], cfg["num_attention_heads"]
    d = cfg.get("head_dim") or h // nq
    return (h, cfg["intermediate_size"], cfg["num_hidden_layers"], nq,
            cfg["num_key_value_heads"], d)


def make_llama(cfg: Dict, seed: int, device) -> Dict:
    h, ffn, nl, nq, nkv, d = dims(cfg)
    dt = getattr(torch, cfg["torch_dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        x = torch.empty(shape, dtype=dt, device=device)
        return x.normal_(0.0, scale, generator=gen)

    kinds = {"wq": (h, nq * d), "wk": (h, nkv * d), "wv": (h, nkv * d),
             "wo": (nq * d, h), "w_gate": (h, ffn), "w_up": (h, ffn),
             "w_down": (ffn, h)}
    stacks = {k: normal((nl, *s), 1.0 / math.sqrt(s[0]))
              for k, s in kinds.items()}
    ones = torch.ones((2 * nl + 1, h), dtype=dt, device=device)
    layers = [{"input_norm": ones[2 * i], "post_attn_norm": ones[2 * i + 1],
               **{k: stacks[k][i] for k in kinds}} for i in range(nl)]
    p = {"embed": normal((cfg["vocab_size"], h), 0.02),
         "final_norm": ones[2 * nl], "layers": layers}
    if not cfg["tie_word_embeddings"]:
        p["lm_head"] = normal((h, cfg["vocab_size"]), 1.0 / math.sqrt(h))
    return p


def _snac_shapes() -> Tuple[List, List]:
    """(uniform tensors: (path, shape, fan_in)), (normal tensors)."""
    s = SNAC
    uni, nor = [], []
    for i in range(len(s["strides"])):
        nor.append((("quantizer", i, "codebook"),
                    (s["codebook_size"], s["codebook_dim"])))
        uni.append((("quantizer", i, "out_proj", "w"),
                    (s["latent_dim"], s["codebook_dim"], 1),
                    s["codebook_dim"]))
    lat, ch = s["latent_dim"], s["decoder_dim"]
    uni.append((("decoder", "in", "dw", "w"), (lat, 1, 7), 7))
    uni.append((("decoder", "in", "pw", "w"), (ch, lat, 1), lat))
    for i, rate in enumerate(s["rates"]):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        uni.append((("decoder", "blocks", i, "up", "w"),
                    (cin, cout, 2 * rate), 2 * rate * cin))
        uni.append((("decoder", "blocks", i, "noise_lin", "w"),
                    (cout, cout, 1), cout))
        for j in range(3):
            uni.append((("decoder", "blocks", i, "res", j, "conv1", "w"),
                        (cout, 1, 7), 7))
            uni.append((("decoder", "blocks", i, "res", j, "conv2", "w"),
                        (cout, cout, 1), cout))
    out = ch // 2 ** len(s["rates"])
    uni.append((("decoder", "out_conv", "w"), (1, out, 7), 7 * out))
    return uni, nor


def make_snac(seed: int, device) -> Dict:
    s = SNAC
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    uni, nor = _snac_shapes()
    ubuf = torch.empty(sum(math.prod(sh) for _, sh, _ in uni), **f32)
    ubuf.uniform_(-1.0, 1.0, generator=gen)
    nbuf = torch.empty(sum(math.prod(sh) for _, sh in nor), **f32)
    nbuf.normal_(0.0, 1.0, generator=gen)
    lat, ch = s["latent_dim"], s["decoder_dim"]
    zeros = lambda n: torch.zeros(n, **f32)  # noqa: E731
    ones = lambda n: torch.ones(n, **f32)  # noqa: E731
    tree = {
        "quantizer": [{"out_proj": {"b": zeros(lat)}}
                      for _ in s["strides"]],
        "decoder": {"in": {"dw": {"b": zeros(lat)}, "pw": {"b": zeros(ch)}},
                    "blocks": [], "out_alpha": ones(ch // 16),
                    "out_conv": {"b": zeros(1)}},
    }
    for i in range(len(s["rates"])):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        tree["decoder"]["blocks"].append({
            "alpha": ones(cin), "up": {"b": zeros(cout)}, "noise_lin": {},
            "res": [{"alpha1": ones(cout), "conv1": {"b": zeros(cout)},
                     "alpha2": ones(cout), "conv2": {"b": zeros(cout)}}
                    for _ in range(3)]})

    def put(path, t):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t

    off = 0
    for path, sh, fan in uni:
        n = math.prod(sh)
        put(path, ubuf[off: off + n].view(sh).mul_(1.0 / math.sqrt(fan)))
        off += n
    off = 0
    for path, sh in nor:
        n = math.prod(sh)
        put(path, nbuf[off: off + n].view(sh))
        off += n
    return tree
