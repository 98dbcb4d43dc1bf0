"""GiB that a training step saves for its backward (trainer / graph
layer): the activations autograd keeps from the forward to the backward,
the weights left out. The graph pool (graph_pool_gib.train) holds them
beside the workspace and the step's temporaries; this is their part.

The program's counter `train.saved_bytes`
(unsupervised_pseuso_lidar_tpu_torch/utils/profiling.counter), which the
train step records on the eager call of its batch shape, the run's first
step, ÷ 2**30. None without a traced slice, or where the program records
no such counter (a program without it)."""

COUNTER = "train.saved_bytes"


def read(run):
    try:
        from unsupervised_pseuso_lidar_tpu_torch.utils.profiling import counter
    except ImportError:
        return None
    if run.slice is None:
        return None
    value = counter(COUNTER)
    return None if value is None else value / 2 ** 30
