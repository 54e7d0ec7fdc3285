from repro_torch.data import loader, partition, synthetic
