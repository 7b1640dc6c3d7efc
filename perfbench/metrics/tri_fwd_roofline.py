"""tri_fwd_roofline.<entry>: the least time of a step's forward on a scene
of matte triangles past 64 surfaces on the H100 (counts/tri.py from the
reference's own K6 cache: a triangle row test a traced lane-bounce, the
Lambertian shading and NEE of each hit, a triangle row test a shadow ray
that reached its light, at the FP32 peak; or K6's cache written once at
the HBM peak, whichever is longer; never the sweeps over rows) over the
device milliseconds of the call's `kytpu::launch.k6` spans, in %, from
the program's spans in the traced window: table_fwd_roofline's reading of
the work that entries/train_tri.py counts."""

from perfbench.metrics.table_fwd_roofline import read  # noqa: F401
