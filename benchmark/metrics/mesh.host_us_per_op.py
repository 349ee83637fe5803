"""Host microseconds a device operation through the index-sharded mesh:
the program's mesh.* batch spans in the traced steps, less the host
syncs inside them, over the device operations of those steps."""
from benchmark import spans


def read(ctx):
    return spans.host_us_per_op(ctx, "mesh.")
