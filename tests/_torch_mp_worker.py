"""One rank of the port's two-process trainer CLI runs, driven by
tests/test_torch_multiprocess.py (not a test module).

Launched with JAX's launch names (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
``PROCESS_ID``) in its own working directory, as on hosts with no shared
filesystem.  It joins the process group once, shrinks the trainers'
configuration to a tiny model and geometry, then runs a trainer CLI
in-process: one epoch, then two with the automatic resume.  Between the runs
a rank other than the lead must hold no checkpoint file (with grain, only
its own stream position); after them the lead's ``g_last`` must be at
epoch 2, step 4.

    python tests/_torch_mp_worker.py synthetic|grain|gan [card]

``synthetic`` and ``grain`` (the ``--loader``) run the stage-1 CLI with
``--resume auto``; ``gan`` runs the stage-2 CLI on synthetic data with
``--resume-g auto --resume-d auto``.  With ``card`` the ranks train on the
GPU (both on one card where there is one: the group is gloo's, since NCCL
refuses two ranks on one device); without it, on the CPU.
"""

import datetime
import os
import sys

import numpy as np

from real_esrgan_tpu_torch import config as run_config
from real_esrgan_tpu_torch import train_realesrgan, train_realesrnet
from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, ModelConfig, PipelineGeometry, TrainConfig,
)
from real_esrgan_tpu_torch.parallel.mesh import process_group, rank
from real_esrgan_tpu_torch.train import checkpoint as ckpt_lib
from real_esrgan_tpu_torch.utils.imgio import write_png

# 16 images / (4 a rank x 2 ranks) = 2 steps an epoch
TRAIN_IMAGES = 16


def main() -> None:
    mode = sys.argv[1]
    grain, gan = mode == "grain", mode == "gan"
    device = ["--cpu"] if sys.argv[2:] != ["card"] else []
    run_config.model = ModelConfig(num_rrdb=1, channels=16, growth_channels=8)
    run_config.degradation = DegradationConfig(usm_radius=13)
    extra = {}
    if grain:
        os.makedirs("train_data", exist_ok=True)
        rng = np.random.default_rng(42)  # the same set on every rank
        for i in range(TRAIN_IMAGES):
            write_png(os.path.join("train_data", f"img_{i:03d}.png"),
                      (rng.random((80, 80, 3)) * 255).astype(np.uint8))
        extra = dict(loader="grain", train_image_dir="train_data")
    if gan:
        trainer = train_realesrgan
        run_config.geometry = PipelineGeometry(hr_size=64, crop_size=64, scale=4)
        run_config.train_esrgan = GanTrainConfig(
            batch_size=8, print_frequency=1, epochs=1, num_workers=2, use_bfloat16=False,
            vgg_nodes=("conv1_2",), content_weights=(1.0,))
        exp_name = run_config.train_esrgan.exp_name
        resume = ["--resume-g", "auto", "--resume-d", "auto"]
    else:
        trainer, exp_name = train_realesrnet, run_config.exp_name
        run_config.geometry = PipelineGeometry(hr_size=64, crop_size=32, scale=4)
        run_config.train_esrnet = TrainConfig(batch_size=8, print_frequency=1, epochs=1,
                                              num_workers=2, use_bfloat16=False, **extra)
        resume = ["--resume", "auto"]

    def args(*more):
        return trainer.build_parser().parse_args(
            [*device, "--epochs", "1", "--batch-size", "8", "--steps-per-epoch", "2",
             "--no-tensorboard", *([] if grain else ["--synthetic"]), *more])

    with process_group("gloo", timeout=datetime.timedelta(seconds=90)):
        me = rank()
        trainer.main(args())
        samples = os.path.join("samples", exp_name)
        if me != 0:
            local = sorted(os.listdir(samples)) if os.path.isdir(samples) else []
            allowed = {f"loader_state_p{me}.bin"} if grain else set()
            assert set(local) <= allowed, f"rank {me} wrote checkpoint files: {local}"
            assert not os.path.exists("results"), f"rank {me} wrote results"
            if grain:
                assert local, f"rank {me} did not save its stream position"
        trainer.main(args("--epochs", "2", *resume))
        if me == 0:
            tree = ckpt_lib.load_checkpoint(os.path.join("results", exp_name, "g_last"))
            assert (int(tree["epoch"]), int(tree["step"])) == (2, 4), (tree["epoch"],
                                                                      tree["step"])
    print(f"MP_WORKER_OK rank={me}", flush=True)


if __name__ == "__main__":
    main()
