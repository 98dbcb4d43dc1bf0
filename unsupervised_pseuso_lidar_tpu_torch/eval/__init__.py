"""PyTorch counterpart of unsupervised_pseuso_lidar_tpu.eval."""
