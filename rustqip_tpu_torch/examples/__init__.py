"""Port twins of the ten programs in ``examples/``: each module has its
original's file name, prints what the original prints, line for line, and
imports only ``rustqip_tpu_torch``, ``torch``, ``numpy`` and the standard
library.

Run one on the card with ``python -m rustqip_tpu_torch.examples.<name>``;
without a card call ``main(device="cpu")`` from Python. Each ``main``
returns a dict of the values it printed, unrounded, so that a caller can
check them beyond the printed digits.
"""
