"""The port's checkpoint import (``tts_inference_tpu_torch/models/loader.py``)
against the JAX package's (``tts_inference_tpu/models/loader.py``) on the
same directories: every leaf bit-equal to
``weights.llama_params_from_jax`` / ``snac_params_from_jax`` of the JAX
loader's tree (tolerance: none), with the strides ``init_llama_params``
lays out. Also the port's checkpoint writers
(``tts_inference_tpu_torch/tools/make_checkpoint.py``) read back by both
loaders."""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax.numpy as jnp  # noqa: E402

from tts_inference_tpu.config import ModelConfig, SnacConfig  # noqa: E402
from tts_inference_tpu.models import loader as jloader  # noqa: E402
from tts_inference_tpu_torch import weights  # noqa: E402
from tts_inference_tpu_torch.models import loader as tloader  # noqa: E402
from tts_inference_tpu_torch.tools import make_checkpoint  # noqa: E402

from tests.torch_port_helpers import port_config  # noqa: E402

TINY = ModelConfig.tiny(vocab_size=512)
LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def assert_trees_equal(got, want, path="params"):
    """Same structure, dtypes, shapes, bytes and strides (contiguous)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.is_contiguous() and got.stride() == want.stride(), path
        assert _bits(got) == _bits(want), path


def save_hf_dir(tmp_path, *, seed=0, tie=True, dtype=torch.float32,
                name="hf", cfg_dtype=None, shard=None, drop=()):
    from tests.test_llama import hf_tiny

    model = hf_tiny(TINY, seed=seed, tie=tie).to(dtype)
    d = tmp_path / name
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(str(d), safe_serialization=True, **kw)
    if cfg_dtype or drop:
        conf = json.loads((d / "config.json").read_text())
        if cfg_dtype:
            conf.pop("dtype", None)
            conf["torch_dtype"] = cfg_dtype
        (d / "config.json").write_text(json.dumps(conf))
        for f in d.glob("*.safetensors"):
            sd = safetensors_torch.load_file(str(f))
            safetensors_torch.save_file(
                {k: v for k, v in sd.items() if k not in drop}, str(f),
                metadata={"format": "pt"})
    return str(d)


def both(path, **kw):
    """(port tree, the JAX loader's tree through llama_params_from_jax,
    the two configs)."""
    jparams, jcfg = jloader.load_llama_checkpoint(path, **kw)
    tparams, tcfg = tloader.load_llama_checkpoint(path, **kw)
    want = weights.llama_params_from_jax(
        {k: (np.asarray(v) if k != "layers" else
             [{n: np.asarray(x) for n, x in lp.items()} for lp in v])
         for k, v in jparams.items()})
    assert tcfg == port_config(jcfg)
    return tparams, want


@pytest.mark.parametrize("tie,dtype,cfg_dtype", [
    (True, torch.bfloat16, None),
    (False, torch.bfloat16, None),
    (True, torch.float32, None),          # an f32 checkpoint loads as f32
    (False, torch.float32, "bfloat16"),   # f32 bytes, config says bf16
])
def test_llama_leaves_bit_equal(tmp_path, tie, dtype, cfg_dtype):
    path = save_hf_dir(tmp_path, tie=tie, dtype=dtype, cfg_dtype=cfg_dtype,
                       shard="60KB")
    got, want = both(path)
    assert ("lm_head" in got) == (not tie)
    assert_trees_equal(got, want)
    # the layout init_llama_params gives: (in, out), contiguous
    cfg = tloader.ModelConfig.from_hf_dict(
        json.loads(open(f"{path}/config.json").read()))
    init = weights.init_llama_params(cfg, 0)
    for k in LINEARS:
        w, ref = got["layers"][0][k], init["layers"][0][k]
        assert w.shape == ref.shape and w.stride() == ref.stride()
        assert w.dtype == ref.dtype


def test_untied_without_lm_head_loads_as_jax_does(tmp_path):
    """An untied config whose files lack lm_head.weight: neither loader
    makes an lm_head leaf (the logits then use the embedding in both)."""
    path = save_hf_dir(tmp_path, tie=False, drop=("lm_head.weight",))
    got, want = both(path)
    assert "lm_head" not in got
    assert_trees_equal(got, want)


def test_explicit_dtype_and_device(tmp_path):
    path = save_hf_dir(tmp_path, dtype=torch.float32)
    jparams, _ = jloader.load_llama_checkpoint(path, dtype=jnp.bfloat16)
    tparams, _ = tloader.load_llama_checkpoint(path, dtype=torch.bfloat16,
                                               device="cpu")
    assert tparams["layers"][1]["wo"].dtype == torch.bfloat16
    assert _bits(tparams["layers"][1]["wo"]) == _bits(
        weights.tensor_from_numpy(np.asarray(jparams["layers"][1]["wo"])))


def _adapter(tmp_path, base_path, *, config=None, dtype=np.float32, r=4,
             seed=1, half_pair=False):
    sd = safetensors_torch.load_file(f"{base_path}/model.safetensors")
    rng = np.random.default_rng(seed)
    out = {}
    for target in ("model.layers.0.self_attn.q_proj",
                   "model.layers.1.mlp.down_proj"):
        w = sd[f"{target}.weight"]
        A = rng.normal(size=(r, w.shape[1])).astype(np.float32)
        B = (rng.normal(size=(w.shape[0], r)) * 0.05).astype(np.float32)
        pre = f"base_model.model.{target}"
        out[f"{pre}.lora_A.weight"] = torch.from_numpy(A).to(
            torch.bfloat16 if dtype == "bf16" else torch.float32)
        out[f"{pre}.lora_B.default.weight"] = torch.from_numpy(B).to(
            torch.bfloat16 if dtype == "bf16" else torch.float32)
    if half_pair:
        out["base_model.model.model.layers.1.self_attn.k_proj.lora_A.weight"] \
            = torch.ones(r, TINY.hidden_size)
    d = tmp_path / "adapter"
    d.mkdir()
    safetensors_torch.save_file(out, str(d / "adapter_model.safetensors"))
    if config is not None:
        (d / "adapter_config.json").write_text(json.dumps(config))
    return str(d)


@pytest.mark.parametrize("base,adapter,config", [
    (torch.bfloat16, np.float32, {"r": 4, "lora_alpha": 8}),
    (torch.bfloat16, np.float32, None),               # alpha 32 / rank
    (torch.float32, np.float32,
     {"r": 4, "lora_alpha": 16, "use_rslora": True}),   # alpha / sqrt(r)
    (torch.float32, "bf16", {"r": 4, "lora_alpha": 8}),
    (torch.bfloat16, "bf16", {"r": 4, "lora_alpha": 8}),
])
def test_lora_merge_bit_equal(tmp_path, base, adapter, config):
    path = save_hf_dir(tmp_path, dtype=base)
    lora = _adapter(tmp_path, path, config=config, dtype=adapter,
                    half_pair=True)
    got, want = both(path, lora_path=lora)
    assert_trees_equal(got, want)
    plain, _ = tloader.load_llama_checkpoint(path)
    # the two targets moved, the half pair (k_proj, A only) did not
    assert not torch.equal(got["layers"][0]["wq"], plain["layers"][0]["wq"])
    assert not torch.equal(got["layers"][1]["w_down"],
                           plain["layers"][1]["w_down"])
    assert torch.equal(got["layers"][1]["wk"], plain["layers"][1]["wk"])


def test_merge_lora_state_missing_pair_ignored():
    sd = {"x.weight": np.eye(3, dtype=np.float32)}
    lora = {"base_model.model.x.lora_A.weight": np.ones((1, 3), np.float32)}
    merged = tloader.merge_lora_state(sd, lora)
    np.testing.assert_array_equal(merged["x.weight"], sd["x.weight"])
    full = dict(lora, **{"base_model.model.x.lora_B.weight":
                         np.full((3, 1), 0.5, np.float32)})
    want = jloader.merge_lora_state(sd, full, alpha=2.0)["x.weight"]
    got = tloader.merge_lora_state(sd, full, alpha=2.0)["x.weight"]
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _snac_dir(tmp_path, cfg, style, name="snac", seed=0):
    """A SNAC dir in one weight-norm style: "old" (weight_g / weight_v),
    "parametrize" (parametrizations.weight.original0 / 1) or "plain"."""
    from tests.torch_snac_ref import TorchSnacRef

    torch.manual_seed(seed)
    ref = TorchSnacRef(cfg).eval()
    # give the gains and alphas values a fresh module does not have
    with torch.no_grad():
        for k, p in ref.named_parameters():
            if k.endswith("weight_g") or k.endswith("alpha"):
                p.mul_(torch.rand_like(p) + 0.5)
    sd = ref.state_dict()
    if style == "parametrize":
        sd = {k.replace("weight_g", "parametrizations.weight.original0")
              .replace("weight_v", "parametrizations.weight.original1"): v
              for k, v in sd.items()}
    elif style == "plain":
        out = {}
        for k, v in sd.items():
            if k.endswith("weight_v"):
                pre = k[:-len(".weight_v")]
                out[f"{pre}.weight"] = torch.from_numpy(
                    jloader.fold_weight_norm(sd, pre).astype(np.float32))
            elif not k.endswith("weight_g"):
                out[k] = v
        sd = out
    d = tmp_path / name
    d.mkdir()
    torch.save(sd, str(d / "pytorch_model.bin"))
    (d / "config.json").write_text(json.dumps({
        "sampling_rate": 24000, "latent_dim": cfg.latent_dim,
        "decoder_dim": cfg.decoder_dim, "decoder_rates": list(
            cfg.decoder_rates), "codebook_size": cfg.codebook_size,
        "codebook_dim": cfg.codebook_dim, "vq_strides": list(cfg.vq_strides),
        "noise": cfg.noise, "depthwise": cfg.depthwise}))
    return str(d)


def _snac_want(jtree):
    import jax

    return weights.snac_params_from_jax(
        jax.tree.map(np.asarray, jtree))


@pytest.mark.parametrize("style", ["old", "parametrize", "plain"])
@pytest.mark.parametrize("noise,depthwise", [(True, True), (False, False)])
def test_snac_leaves_bit_equal(tmp_path, style, noise, depthwise):
    cfg = SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4,
                     codebook_size=64, noise=noise, depthwise=depthwise)
    d = _snac_dir(tmp_path, cfg, style)
    jtree, jcfg = jloader.load_snac_checkpoint(d)
    got, tcfg = tloader.load_snac_checkpoint(d)
    assert tcfg == port_config(jcfg)
    assert_trees_equal(got, _snac_want(jtree))
    blocks = got["decoder"]["blocks"]
    assert (blocks[0]["noise_lin"] is None) == (not noise)
    assert ("dw" in got["decoder"]["in"]) == depthwise


def test_snac_config_json_wins_and_files(tmp_path):
    cfg = SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4,
                     codebook_size=64)
    d = _snac_dir(tmp_path, cfg, "old")
    _, tcfg = tloader.load_snac_checkpoint(d)
    assert (tcfg.codebook_size, tcfg.latent_dim) == (64, 32)
    import os

    os.rename(f"{d}/pytorch_model.bin", f"{d}/snac.pt")
    got, _ = tloader.load_snac_checkpoint(d)
    assert got["quantizer"][0]["codebook"].shape == (64, 4)
    os.remove(f"{d}/snac.pt")
    with pytest.raises(FileNotFoundError):
        tloader.load_snac_checkpoint(d)


def test_port_writers_load_in_both_packages(tmp_path):
    """make_checkpoint's HF dir (bf16, sharded, untied) and SNAC dir, read by
    the JAX loader and by the port's: the leaves are the port's own."""
    import dataclasses

    from tts_inference_tpu_torch import config as tcfg

    cfg = dataclasses.replace(port_config(TINY), dtype="bfloat16",
                              tie_word_embeddings=False)
    params = weights.init_llama_params(cfg, seed=3)
    info = make_checkpoint.write_llama_checkpoint(
        params, cfg, str(tmp_path / "m"), shard_bytes=40_000)
    assert info["shards"] > 1
    got, want = both(str(tmp_path / "m"))
    assert_trees_equal(got, params)
    assert_trees_equal(want, params)

    scfg = tcfg.SnacConfig(latent_dim=32, decoder_dim=64, codebook_dim=4,
                           codebook_size=64)
    vparams = weights.init_snac_params(scfg, seed=4)
    make_checkpoint.write_snac_checkpoint(vparams, scfg, str(tmp_path / "s"))
    jtree, jcfg = jloader.load_snac_checkpoint(str(tmp_path / "s"))
    tree, scfg2 = tloader.load_snac_checkpoint(str(tmp_path / "s"))
    assert scfg2 == scfg and port_config(jcfg) == scfg
    assert_trees_equal(tree, vparams)
    assert_trees_equal(_snac_want(jtree), vparams)
