"""The port's ``tools/run_inenv10_program.sh``, the two-stage InEnv10
program, checked without running it (the card test
``test_torch_cuda_research.py::test_the_inenv10_program_on_the_card`` runs it):

* ``bash -n`` parses it;
* every Python command it runs is ``python -m real_esrgan_tpu_torch.<cli>``
  (through ``$PY``), none a root script of the JAX package;
* its lock is the bench's ``GPU_BUSY_LOCK``, not the TPU lock;
* every such command line, with its shell words filled in, parses under that
  CLI's own parser (the trainers', ``eval_pair``'s, ``snapshot_weights``');
* it works in ``INENV10_ROOT``, by default the repository root.
"""

import importlib
import os
import re
import shlex
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "real_esrgan_tpu_torch", "tools", "run_inenv10_program.sh")
# shell words the command lines use, as the script sets them
WORDS = {"${S1_EPOCHS:-700}": "700", "${S2_EPOCHS:-70}": "70", "$lr": "data/lr",
         "$hr": "data/hr", "$weights": "results/x/g_best", "$@": "--use-params"}
PARSERS = {"real_esrgan_tpu_torch.train_realesrnet": "train_realesrnet",
           "real_esrgan_tpu_torch.train_realesrgan": "train_realesrgan",
           "real_esrgan_tpu_torch.scripts.eval_pair": "eval_pair",
           "real_esrgan_tpu_torch.scripts.snapshot_weights": "snapshot_weights"}


def _text():
    with open(SCRIPT) as f:
        return f.read()


def _commands():
    """Each ``"$PY" -m <module> ...`` command, continuation lines joined,
    cut at its redirection or pipe: (module, argv)."""
    joined = _text().replace("\\\n", " ")
    out = []
    for line in joined.splitlines():
        m = re.search(r'"\$PY" -m (\S+)(.*)', line)
        if not m:
            continue
        rest = re.split(r"\s(?:>>|2>|\|)\s?", m.group(2))[0]
        for word, value in WORDS.items():
            rest = rest.replace(f'"{word}"', value).replace(word, value)
        out.append((m.group(1), shlex.split(rest)))
    return out


def test_bash_parses_it():
    subprocess.run(["bash", "-n", SCRIPT], check=True)


def test_it_runs_only_the_ports_clis():
    text = _text()
    commands = _commands()
    assert sorted({module for module, _ in commands}) == sorted(PARSERS)
    assert len(commands) == 5  # two trainers, eval_pair (in score), two snapshots
    code = [line for line in text.splitlines() if not line.lstrip().startswith("#")]
    assert not [line for line in code if re.search(r"python3? (scripts|tools)/|\.py\b", line)]
    assert "GPU_BUSY_LOCK" in text and "tpu_busy" not in text
    assert 'ROOT="${INENV10_ROOT:-$REPO}"' in text and 'cd "$ROOT"' in text


@pytest.mark.parametrize("index", range(5))
def test_each_command_parses_under_its_cli(index):
    module, argv = _commands()[index]
    cli = importlib.import_module(module)
    args = cli.build_parser().parse_args(argv)
    if module.endswith("train_realesrnet"):
        assert (args.epochs, args.batch_size, args.lr, args.warmup_steps) == (700, 16, 1e-4, 500)
        assert args.resume == "auto" and args.abort_on_storm and args.no_tensorboard
    if module.endswith("train_realesrgan"):
        assert (args.content_backbone, args.resume_g, args.resume_d) == ("trunk", "auto", "auto")
        assert args.resume == "results/RealESRNet_inenv10/g_best" and args.epochs == 70
    if module.endswith("snapshot_weights"):
        assert args.output.startswith("assets/inenv10_") and args.output.endswith("_ema.npz")


def test_a_child_process_logs_its_rdb_kernel_launches(tmp_path):
    """The program's CLIs run as child processes: each appends its RDB kernel
    launches to ``FUSED_RDB_LAUNCH_LOG`` as it exits, which is how a parent
    counts them."""
    import json
    import sys

    log = tmp_path / "launches.jsonl"
    code = ("from real_esrgan_tpu_torch.ops.fused_rdb import fused_rdb; "
            "fused_rdb.launches += 7")
    for _ in range(2):
        subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                       env={**os.environ, "FUSED_RDB_LAUNCH_LOG": str(log)})
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert [line["launches"] for line in lines] == [7, 7]
    assert lines[0]["pid"] != lines[1]["pid"]
