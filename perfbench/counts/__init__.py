"""Work counts, from shapes alone, fixed whatever implements the work.

``peaks``: the card's published peaks; ``kernels``: each kernel's
operations and bytes per call; ``step``: the FLOPs a step's result
reads (the model's rows that carry work, causal attention halved, the
demux rows, the heads and losses the task reads).
"""
