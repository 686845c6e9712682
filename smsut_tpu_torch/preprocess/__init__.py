# -*- coding: utf-8 -*-
"""Volume preparation on the host: the port of ``smsut_tpu/preprocess/``
(NIfTI and DICOM reading, spacing resample and crop, the BTCV and CHAOS
preparations, PNG slices and the split), on numpy, scipy and the port's
own PNG codec (``utils/io.py``); no OpenCV."""
