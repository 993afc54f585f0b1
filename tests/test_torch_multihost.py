"""The port's twin of tests/test_multihost.py::
test_two_process_mesh_matches_single_process: two processes form one
torch.distributed group over localhost (gloo; tests/torch_multihost_driver.py),
lay the global (dp, tp) mesh over both, and run a LoRA train step and a
prefill digest. Both processes agree exactly (lockstep), and their numbers
equal one process's unsharded run within the JAX test's 2e-5.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests import torch_multihost_driver
from tests.torch_gloo_pool import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(ROOT, "tests", "torch_multihost_driver.py")


@pytest.mark.parametrize("tp", [1, 2], ids=["dp2", "tp2"])
def test_two_process_mesh_matches_single_process(tp):
    """tp 1: dp 2 crosses the processes (the JAX test's cross-host axis);
    tp 2: the tensor-parallel sums cross them."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen([sys.executable, DRIVER, str(pid), "2",
                               str(port), str(tp)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"child failed:\n{out}\n{err}"
        outs.append(out)
    parsed = []
    for out in outs:
        m = re.search(r"MHOK pid=(\d) dp=(\d) tp=(\d) loss=(\S+) "
                      r"digest=(\S+)", out)
        assert m, f"no MHOK line in child output:\n{out}"
        parsed.append(m)
    for m in parsed:
        assert (int(m.group(2)), int(m.group(3))) == (2 // tp, tp)
    assert parsed[0].group(4, 5) == parsed[1].group(4, 5)
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss_ref, digest_ref = torch_multihost_driver.compute(dp=2 // tp)
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(float(parsed[0].group(4)), loss_ref,
                               rtol=2e-5)
    np.testing.assert_allclose(float(parsed[0].group(5)), digest_ref,
                               rtol=2e-5)
