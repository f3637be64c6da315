"""kernel.replay_roofline: the stage-2 stream replay's share of its
roofline, in percent: one product a plan entry a curve at the card's
peaks (kernels/K5.py on the digit engine, kernels/K15.py on RNS) over the
kernel's device seconds in the window's trace, summed over the cards."""

KERNELS = {"digit": "K5", "rns": "K15"}


def read(run):
    return run.roofline(KERNELS.get(run.engine))
