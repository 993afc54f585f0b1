"""Runs the port's launcher (tts_inference_tpu_torch/deploy/launch.py) with
its server commands swapped for tests/torch_stub_server.py, so that the
supervision policies run in seconds: `python tests/torch_launch_driver.py
[launch flags] -- [flags for the stub]`. The router child stays the port's
own. Nothing of the program changes: the driver replaces the module's
command functions before `main` runs."""

import sys
from pathlib import Path

from tts_inference_tpu_torch.deploy import launch

STUB = [sys.executable, str(Path(__file__).with_name("torch_stub_server.py"))]


def stub_serve_cmd(host, port, serve_args):
    return [*STUB, "--host", host, "--port", str(port), *serve_args]


def stub_lockstep_cmd(rank, n, coordinator_port, lockstep_port, host, port,
                      serve_args):
    where = ["--host", host, "--port", str(port)] if rank == 0 else []
    return [*STUB, *where, *serve_args]


if __name__ == "__main__":
    launch.serve_cmd = stub_serve_cmd
    launch.lockstep_cmd = stub_lockstep_cmd
    sys.exit(launch.main(sys.argv[1:]))
