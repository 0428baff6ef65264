"""The port's trainer CLIs as two processes (gloo on localhost, JAX's
launch names), each in its own working directory as on hosts with no
shared filesystem: one epoch, then the automatic resume to epoch 2 (stage 1
``--resume auto``; stage 2 ``--resume-g auto --resume-d auto``).  The lead
resolves the checkpoints and sends the paths and the state; rank 1 holds no
checkpoint file and must still print the resumed epoch.  With ``--loader
grain`` each rank saves and restores its own stream position
(``loader_state_p{rank}.bin``).  The worker is tests/_torch_mp_worker.py;
each run is bounded by ``TIMEOUT`` seconds and retried once only when a
rank never joined the group.
"""

import os

import pytest

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch.tools.dp_check import launch_local

TIMEOUT = 120.0
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mp_worker.py")


@pytest.mark.parametrize("loader", ["synthetic", "grain", "gan"])
def test_two_process_cli_resumes_on_both_ranks(tmp_path, loader):
    cwds = [tmp_path / f"rank{r}" for r in range(2)]
    for cwd in cwds:
        cwd.mkdir()
    runs = launch_local([WORKER, loader], 2, TIMEOUT, cwds=[str(c) for c in cwds],
                        env={"OMP_NUM_THREADS": "2"})
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"MP_WORKER_OK rank={r}" in out
        assert f"rank {r} of 2" in out
        assert "2 steps/epoch, 2 ranks of 4" in out, out[-2000:]
        assert "at epoch 1." in out, out[-2000:]  # the broadcast resume epoch
        if loader == "gan":
            assert "Resumed discriminator" in out
        assert "Epoch: [2]" in out
        if loader == "grain":
            assert "Using grain-contract stream loader" in out
            assert "Restored data-loader stream position." in out, out[-2000:]
    assert not (cwds[1] / "results").exists()
    assert (cwds[0] / "results").is_dir()
    if loader == "grain":
        samples = [sorted(os.listdir(c / "samples" / run_config.exp_name)) for c in cwds]
        assert "loader_state_p0.bin" in samples[0]
        assert samples[1] == ["loader_state_p1.bin"]
