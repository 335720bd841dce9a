"""mfu.decode: the decode steps' roofline share (%): their least time
(weights read once a step and each active row's own K/V at 3.35 TB/s,
or FLOPs at 989 TF/s, whichever binds: bytes at these shapes) over their
device time inside the decode spans."""
from gpubench.readers import decode_roofline as read  # noqa: F401
