"""driver.pack_s: seconds a batch spends packing its built curves into
the engine's stage-1 state on the host (digit planes, or on RNS the CRT
residues) and copying it to the cards, from ECMDriver.timings["pack"]
over the window's batches: the part of driver.build_s after the curves
are built."""


def read(run):
    if not run.batches or "pack" not in run.timings:
        return None
    return run.timings["pack"] / run.batches
