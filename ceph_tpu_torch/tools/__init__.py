"""Measurement aids run on the card by hand (``python3 -m
ceph_tpu_torch.tools.<name>``); nothing in the package imports them."""
