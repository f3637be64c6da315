"""stage1.readback_s: seconds a batch spends reading stage 1's point back
to the host (device-to-host copy, unpacking, out of Montgomery form;
mid-stage-1 checkpoints included), after the wait for the kernels, from
ECMDriver.timings["stage1_readback"] over the window's batches.  On one
card nothing is queued on the device meanwhile: the card idles."""


def read(run):
    if not run.batches or "stage1_readback" not in run.timings:
        return None
    return run.timings["stage1_readback"] / run.batches
