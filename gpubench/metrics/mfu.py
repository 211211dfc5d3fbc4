"""The whole step's share of the chips' peak, in %: the model FLOPs of the
window's steps over the window's seconds and the bf16 peak of every chip
the run uses."""


def read(run):
    return 100.0 * run.window_flops / run.window_s / (run.peak_flops
                                                      * run.chips)
