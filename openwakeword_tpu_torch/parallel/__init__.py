"""Multi-stream engine, serving runtime and bulk scoring of the PyTorch port
(counterpart of ``openwakeword_tpu.parallel``)."""
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
from openwakeword_tpu_torch.parallel.mesh import Mesh, fetch_sharded, put_sharded
from openwakeword_tpu_torch.parallel.bulk import bulk_predict
from openwakeword_tpu_torch.parallel.server import StreamServer

__all__ = ["MultiStreamEngine", "Mesh", "bulk_predict", "fetch_sharded", "put_sharded", "StreamServer"]
