"""driver.build_s: seconds a batch spends building its curves on the host
(Suyama from sigma, Montgomery form, state packing; on RNS the CRT
packing into residues), from ECMDriver.timings["build"] over the window's
batches."""


def read(run):
    if not run.batches or "build" not in run.timings:
        return None
    return run.timings["build"] / run.batches
