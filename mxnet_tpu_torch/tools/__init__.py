"""Tools of the PyTorch port: the job launcher (:mod:`.launch`) and the
chip probes, which run as scripts."""
