"""A tiny configuration and traffic mix for running the harness on the
CPU: the port's full path at test size."""

TINY_MODEL = {
    "name": "tiny", "model_type": "llama", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "max_position_embeddings": 512,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": True,
    "torch_dtype": "float32", "vocab_size": 156940,
    "engine": {"max_batch_size": 4, "decode_steps_per_call": 7,
               "kv_cache": "dense bfloat16", "sliced_head": True},
    "snac": {"dtype": "float32"},
    "check": {"logit_gap_max": 1e-3, "logit_gap_mean": 1e-4,
              "pcm_rms_lsb": 0.1},
}

TINY_OPEN = {
    "loop": "open", "rate_per_s": 2.0, "ramp_s": 1.0, "drain_s": 60.0,
    "audio_s": {"dist": "uniform", "min": 0.25, "max": 0.6},
    "text_bytes": {"dist": "uniform", "min": 10, "max": 40},
    "greedy_share": 0.5, "voice": "tara",
    "engine": {"prefill_buckets": [32, 64], "max_input_len": 64,
               "max_output_len": 64, "kv_buckets": [64]},
    "check": {"greedy": 2, "sampled": 1},
}

TINY_CLOSED = dict(TINY_OPEN, loop="closed", clients=3, ramp_s=0.5)
