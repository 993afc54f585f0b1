"""The dense Llama-style block the port's `models/llama.py` runs: GQA or
MHA attention with default rotary positions, SwiGLU, RMSNorm, no biases,
a tied or untied head. Weights `weights.make_llama`, reference
`reference/llama.py`, decode FLOPs and K1 bound `roofline.decode_launch`."""

from __future__ import annotations

from typing import Dict

from ttsbench import roofline, serve, weights
from ttsbench.reference import llama as ref_llama

MODEL_TYPES = ("llama", "mistral")

# Keys of a configuration file that change what the block computes. The
# port's decoder and the benchmark's reference implement neither rope
# scaling, a sliding window, biases nor another activation, so a
# configuration that states one is refused rather than run without it.
UNSUPPORTED = {"rope_scaling": None, "sliding_window": None,
               "attention_bias": False, "mlp_bias": False,
               "hidden_act": "silu"}


def port_config(model: Dict, mix: Dict):
    from tts_inference_tpu_torch.config import ModelConfig

    for key, plain in UNSUPPORTED.items():
        if model.get(key, plain) != plain:
            raise ValueError(f"{key} = {model[key]!r}: the benchmark runs "
                             f"only {key} = {plain!r}")
    h, nq = model["hidden_size"], model["num_attention_heads"]
    mc = ModelConfig(
        vocab_size=model["vocab_size"], hidden_size=h,
        intermediate_size=model["intermediate_size"],
        num_hidden_layers=model["num_hidden_layers"],
        num_attention_heads=nq,
        num_key_value_heads=model["num_key_value_heads"],
        head_dim=model.get("head_dim") or h // nq,
        rms_norm_eps=model["rms_norm_eps"], rope_theta=model["rope_theta"],
        rope_scaling_factor=None,
        max_position_embeddings=model["max_position_embeddings"],
        tie_word_embeddings=model["tie_word_embeddings"],
        dtype=model["torch_dtype"])
    return serve.assemble_config(mc, model, mix)


make_weights = weights.make_llama
logits = ref_llama.logits
decode_launch = roofline.decode_launch


def control_params(params: Dict) -> Dict:
    """The port's own int8 path, from the same bf16 weights (kept)."""
    from tts_inference_tpu_torch.models.quant import quantize_llama_params

    return quantize_llama_params(dict(params, layers=[
        dict(lp) for lp in params["layers"]]), bits=8)

