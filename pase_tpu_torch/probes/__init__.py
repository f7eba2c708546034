"""Downstream probes on a frozen encoder: feature extraction
(``extract``), classifier heads and their training (``classifier``), the
probe tasks (``tasks``) and the TIMIT decoding pipeline
(``timit_decode``). The port of ``pase_tpu.probes``."""
