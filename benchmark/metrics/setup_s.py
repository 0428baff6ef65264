"""Set-up seconds: process start to the first measured unit (imports,
CUDA's start, weights, pipeline, inputs, warm-up; in a checkout's first
run also the kernels' build, which the result's ``setup`` key reports
apart beside each phase)."""


def read(outcome, ctx):
    return outcome.setup_s
