"""
Multi-device and multi-process work for the port (the counterpart of
gance_tpu/parallel/):

  * data axis: frame and sample batches split over a mesh's devices
    (`mesh.py`, `sharded_synthesis.py`), in synthesis, training
    (`training.py`) and projection;
  * model axis: the large conv and dense weights split over a data row's
    model slots by output channel, each layer run column-parallel
    (`tensor_parallel.py`), in synthesis, serving and training;
  * network axis: every network resident on its own device group
    (`network_parallel.py`);
  * processes: `distributed.py` joins a torch.distributed group (NCCL where
    each rank owns its GPUs, gloo on the CPU and where ranks share a GPU),
    after which a mesh spans every process's devices (the model axis stays
    inside each process).
"""
