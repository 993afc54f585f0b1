"""How `correct` is decided: the reference against what the timed path
produced, for a sample of the requests it finished (`sample.choose`).

Per compared request:
- the prompt the port prefilled equals the reference's envelope of the text;
- it served exactly `max_tokens` tokens (speech is forced, the audio range
  holds no end token), each inside the audio id range;
- greedy requests: teacher-forced float32 reference logits over the audio
  range, with the requests' repetition penalty (1.1) on the ids already
  served; the number is the widest gap by which a served token's logit
  lies below the reference's best, and the mean of those gaps over all
  compared positions;
- every compared request: its PCM as the client received it against the
  reference vocoder's decode of its served codes: the root mean square
  of the difference in 16-bit steps (LSB). (Its largest difference reads
  1 LSB for the port and for the TF32 control alike, so it separates
  nothing and is not compared.)

The limits are the configuration's (`check` in its file), set from the
readings that PERF.md lists."""

from __future__ import annotations

import base64
import math
from typing import Dict, List

import numpy as np
import torch

from ttsbench import families
from ttsbench.reference import protocol as P
from ttsbench.reference import snac as ref_snac

PENALTY = 1.1          # the requests' repetition penalty (server default)
COUNTS = ("unanswered", "prompt_mismatch", "length_mismatch",
          "out_of_range")
LIMITED = ("logit_gap_max", "logit_gap_mean", "pcm_rms_lsb")


def gaps(logits: torch.Tensor, served: List[int]) -> torch.Tensor:
    """Gap of each served token below the best penalised reference logit,
    over the audio range; logits row i predicts served[i]."""
    n = len(served)
    idx = torch.as_tensor(served, device=logits.device) - P.AUDIO_BASE
    v = logits.shape[1]
    first = torch.full((v,), n, dtype=torch.long, device=logits.device)
    first.scatter_reduce_(0, idx, torch.arange(n, device=logits.device),
                          reduce="amin")
    seen = first[None, :] < torch.arange(n, device=logits.device)[:, None]
    pen = torch.where(logits > 0, logits / PENALTY, logits * PENALTY)
    lg = torch.where(seen, pen, logits)
    got = lg.gather(1, idx[:, None])[:, 0]
    return lg.max(dim=1).values - got


def compare(model: Dict, params, snac, requests: Dict[int, Dict],
            served: Dict[str, Dict], out: Dict,
            vocoder_control: bool = False) -> Dict[str, float]:
    """The numbers compared; the logits are the configuration's family's
    reference (`families.of`). `vocoder_control`: the reference vocoder in
    TF32 stands in the port's place for the PCM (the control)."""
    family = families.of(model)
    n = {k: 0 for k in COUNTS}
    worst, gsum, gcnt, sq, cnt = [], 0.0, 0, 0.0, 0
    lo, hi = P.AUDIO_RANGE
    for key, b64 in out["pcm"].items():
        r = requests[int(key)]
        got = served.get(r["text"])
        if got is None:
            n["unanswered"] += 1
            continue
        prompt, toks = got["prompt"], got["tokens"]
        if prompt != P.prompt_ids(r["text"], r["voice"]):
            n["prompt_mismatch"] += 1
        pcm = np.frombuffer(base64.b64decode(b64), dtype=np.int16)
        if len(toks) != r["max_tokens"] or \
                len(pcm) != (len(toks) // P.FRAME) * 2048:
            n["length_mismatch"] += 1
            continue
        if any(t < lo or t >= hi for t in toks):
            n["out_of_range"] += 1
            continue
        if r["greedy"]:
            lg = family.logits(params, model, prompt + toks[:-1],
                               len(prompt) - 1, lo, hi)
            g = gaps(lg, toks)
            worst.append(float(g.max()))
            gsum += float(g.sum())
            gcnt += len(toks)
            del lg, g
        layers = P.layers_of(toks)
        want = ref_snac.pcm16(ref_snac.decode(snac, layers))
        if vocoder_control:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                pcm = ref_snac.pcm16(ref_snac.decode(snac, layers))
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
        d = pcm.astype(np.int64) - want.astype(np.int64)
        sq += float((d * d).sum())
        cnt += len(d)
    nums = {k: float(v) for k, v in n.items()}
    nums["compared"] = float(len(out["pcm"]))
    nums["logit_gap_max"] = max(worst) if worst else math.nan
    nums["logit_gap_mean"] = gsum / gcnt if gcnt else math.nan
    nums["pcm_rms_lsb"] = math.sqrt(sq / cnt) if cnt else math.nan
    return nums


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number beside its limit (counts: 0); correct when every number
    is a number within its limit and something was compared. A
    configuration compares the numbers its `check` lists: those that
    separate its sound runs from its control (PERF.md)."""
    lines = {k: {"value": nums[k], "limit": 0.0} for k in COUNTS}
    for k in (k for k in LIMITED if k in limits):
        lines[k] = {"value": nums[k], "limit": float(limits[k])}
    ok = nums["compared"] > 0 and all(
        not math.isnan(v["value"]) and v["value"] <= v["limit"]
        for v in lines.values())
    # the one number held from below: something has to be compared
    lines["requests_compared"] = {"value": nums["compared"], "limit": 1.0}
    return {"correct": bool(ok), "lines": lines}
