# -*- coding: utf-8 -*-
"""The preparation CLIs of the port, run as ``python -m
smsut_tpu_torch.data_pprocess.<name>``: BTCV and CHAOS volumes to the
nii.gz tree (``atlasPreparation``, ``chaosPreparation``), then the PNG
slice tree and the split YAML that the trainers read (``toPngAndSplit``).
Host code only: numpy, scipy and the port's own codecs."""
