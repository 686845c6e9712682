# -*- coding: utf-8 -*-
"""Data parallelism across processes, one process per card
(``torch.distributed``): the group (``distributed``) and the collectives
the train state, the losses and the fit loop call (``mesh``)."""
