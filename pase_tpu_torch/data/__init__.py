"""Data of the port: wav IO, corpora and batchers, batch preparation, the
distortion stack, the feature cache and the card-resident corpus."""
