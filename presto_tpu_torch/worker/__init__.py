"""The port's worker shell: the HTTP task plane, the coordinator's client
statement plane and the distributed coordinator around the PyTorch/CUDA
engine (the port of presto_tpu/worker/, the analog of
presto-native-execution/presto_cpp)."""
from .server import WorkerServer              # noqa: F401
from .coordinator import HttpQueryRunner      # noqa: F401
