"""Run configuration of the port's trainers: its own copy of the values in
the repository-root ``config.py``.

The root module builds its dataclasses from the JAX package, so the port
cannot import it; the values here are the same (``geometry`` hr 400 -> crop
256 at x4, the full ``ModelConfig``, ``TrainConfig`` and ``GanTrainConfig``
defaults, the stage-2 warm start from stage 1's ``g_last``).  The trainers
read them at call time, so a test can replace one with ``monkeypatch``.
"""

from real_esrgan_tpu_torch.configuration import (
    DegradationConfig, GanTrainConfig, KernelSynthesisConfig, ModelConfig, PipelineGeometry,
    TrainConfig,
)

kernel_synthesis = KernelSynthesisConfig()
degradation = DegradationConfig()
geometry = PipelineGeometry(hr_size=400, crop_size=256, scale=4)
model = ModelConfig()
train_esrnet = TrainConfig()
train_esrgan = GanTrainConfig(resume="./results/RealESRNet_baseline/g_last")

exp_name = "RealESRNet_baseline"

# NIQE pristine statistics, relative to the working directory as the root
# module gives them; the trainers score with metrics.niqe's own default
niqe_model_path = "./assets/niqe_model.mat"
