"""stage2.modinv_s: seconds a batch spends in stage 2's host batch
inverses (the gcd screen, the prefix products, one modular inverse a Pa
group and the back pass), from ECMDriver.timings["stage2_modinv"] over
the window's batches: the part of stage2.host_s that no change of
representation removes."""


def read(run):
    if not run.batches or "stage2_modinv" not in run.timings:
        return None
    return run.timings["stage2_modinv"] / run.batches
