"""stage2.host_s: seconds a batch spends in stage 2's host crossings,
after the wait for the kernels: the planes' conversion to Python ints and
back with their copies (the CRT on RNS), the accumulator's read-back, and
the host's batch inverse of each Pa group, from ECMDriver.timings
["stage2_convert"] + ["stage2_modinv"] over the window's batches."""

KEYS = ("stage2_convert", "stage2_modinv")


def read(run):
    if not run.batches or not any(k in run.timings for k in KEYS):
        return None
    return sum(run.timings.get(k, 0.0) for k in KEYS) / run.batches
