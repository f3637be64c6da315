"""stage2.plan_wait_s: seconds a batch waits for the host's stage-2 plan
(prime sieve and pairing, one chunk ahead on a thread), from
ECMDriver.timings["stage2_plan_wait"] over the window's batches.  The
plan is made in the window's first batch and reused by the others, as in
a user's job; a wait too short to be timed reads 0."""


def read(run):
    if not run.batches or "stage2" not in run.timings:
        return None
    return run.timings.get("stage2_plan_wait", 0.0) / run.batches
