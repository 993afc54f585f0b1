"""The port's safetensors reader and writer
(``tts_inference_tpu_torch/utils/safetensors_io.py``) against the
``safetensors`` library: files the library wrote read back bit-equal, and
files the port wrote read back bit-equal by the library."""

import json
import os

import numpy as np
import pytest
import torch

safetensors_torch = pytest.importorskip("safetensors.torch")

from tts_inference_tpu_torch.utils import safetensors_io as st  # noqa: E402

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
          torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
          torch.bool]


def _tensors(seed=0):
    """Every dtype, 0-d, empty and odd lengths (so that later tensors of a
    smaller element size would start unaligned without the ordering)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 5), (7,), (), (0, 4), (2, 3, 1)][i % 5]
        x = torch.randn(shape, generator=g) * 100
        if dt == torch.bool:
            x = x > 0
        out[f"t{i}.{str(dt).split('.')[-1]}"] = x.to(dt)
    out["odd_u8"] = torch.arange(3, dtype=torch.uint8)
    out["scalar_bf16"] = torch.tensor(1.5, dtype=torch.bfloat16)
    return out


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert _bits(a[k]) == _bits(b[k]), k


def test_reads_the_librarys_files(tmp_path):
    want = _tensors()
    p = str(tmp_path / "lib.safetensors")
    safetensors_torch.save_file(want, p, metadata={"format": "pt", "a": "b"})
    got = st.read_file(p)
    _same(got, want)
    assert st.read_metadata(p) == {"format": "pt", "a": "b"}
    # views of a private mapping: writable, and writing leaves the file be
    t = got["t2.float32"]
    t += 1
    _same(st.read_file(p), want)


def test_library_reads_the_ports_files(tmp_path):
    want = _tensors(1)
    p = str(tmp_path / "port.safetensors")
    n = st.write_file(p, want, metadata={"k": "v"})
    assert n == sum(t.numel() * t.element_size() for t in want.values())
    _same(safetensors_torch.load_file(p), want)
    _same(st.read_file(p), want)
    from safetensors import safe_open

    with safe_open(p, framework="pt") as f:
        assert f.metadata() == {"k": "v"}
    # every tensor starts aligned to its element size
    data0, header = st.read_header(p)
    assert data0 % 8 == 0
    for k, info in header.items():
        if k != "__metadata__":
            assert info["data_offsets"][0] % want[k].element_size() == 0, k


def test_reads_a_sharded_dir_by_its_index(tmp_path):
    pytest.importorskip("transformers")
    from tests.test_llama import hf_tiny
    from tts_inference_tpu.config import ModelConfig

    m = hf_tiny(ModelConfig.tiny(vocab_size=512), seed=2)
    d = tmp_path / "hf"
    m.save_pretrained(str(d), safe_serialization=True, max_shard_size="100KB")
    shards = sorted(f for f in os.listdir(d) if f.endswith(".safetensors"))
    assert len(shards) > 1 and (d / "model.safetensors.index.json").exists()
    # a stray file the index does not name is not read
    safetensors_torch.save_file({"stray": torch.zeros(2)},
                                str(d / "zz-stray.safetensors"))
    got = st.read_dir(str(d))
    want = {k: v for k, v in m.state_dict().items() if k != "lm_head.weight"}
    _same(got, want)
    weight_map = json.loads(
        (d / "model.safetensors.index.json").read_text())["weight_map"]
    assert sorted(got) == sorted(weight_map)


def test_read_dir_without_an_index_reads_every_file_in_order(tmp_path):
    safetensors_torch.save_file({"a": torch.ones(2)},
                                str(tmp_path / "b.safetensors"))
    safetensors_torch.save_file({"b": torch.zeros(3, dtype=torch.bfloat16)},
                                str(tmp_path / "a.safetensors"))
    got = st.read_dir(str(tmp_path))
    assert list(got) == ["b", "a"]
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        st.read_dir(str(tmp_path / "empty"))


@pytest.mark.parametrize("bad", ["dtype", "offsets", "header"])
def test_rejects_malformed_files(tmp_path, bad):
    p = str(tmp_path / "x.safetensors")
    st.write_file(p, {"x": torch.arange(4, dtype=torch.int32)})
    data0, header = st.read_header(p)
    raw = open(p, "rb").read()
    if bad == "dtype":
        header["x"]["dtype"] = "F8_E4M3"
    elif bad == "offsets":
        header["x"]["data_offsets"] = [0, 12]
    body = json.dumps(header).encode()
    if bad == "header":
        blob = (10 ** 6).to_bytes(8, "little") + body
    else:
        blob = len(body).to_bytes(8, "little") + body + raw[data0:]
    open(p, "wb").write(blob)
    with pytest.raises(ValueError):
        st.read_file(p)


def test_bf16_without_numpy_bf16():
    """bf16 bytes round-trip through the writer and reader; the values are
    those of numpy's float32 view of the same bits."""
    x = torch.randn(64).to(torch.bfloat16)
    f32 = (x.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
           << 16).view(np.float32)
    np.testing.assert_array_equal(x.float().numpy(), f32)
