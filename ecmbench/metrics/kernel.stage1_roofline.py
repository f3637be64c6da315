"""kernel.stage1_roofline: the stage-1 tape kernel's share of its
roofline, in percent: the least time the window's stage-1 work needs at
the card's peaks (kernels/K1.py on the digit engine, kernels/K10.py on
RNS) over the kernel's device seconds in the window's trace, summed over
the cards."""

KERNELS = {"digit": "K1", "rns": "K10"}


def read(run):
    return run.roofline(KERNELS.get(run.engine))
