"""The program's side of each model family: the port's model and loss as
a user builds them on the benchmark's weights, the family's batches drawn
from a traffic file and a seed, and its FLOP and bound counts.  A
configuration names its family (``"family"``) and its plain reference
(``"reference"``); the harness imports both by those names.

Each family module gives ``rows(traffic)``, ``block(cfg, traffic, seed,
index, rank, device)`` (one rank's rows of pool entry ``index``, a dict
of tensors that the program's loss and the reference both read),
``build(cfg, state)`` (the port's model on ``state`` and its loss
function), ``step_flops(cfg, traffic, index, world)`` and
``attention_bound_s(cfg, block)`` (None where the family has no
attention).
"""
