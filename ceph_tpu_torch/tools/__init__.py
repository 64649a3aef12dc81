"""Tools run by hand (``python3 -m ceph_tpu_torch.tools.<name>``): the
measurement aids for the card and the seeded thrash runner (``thrash``);
nothing in the package imports them."""
