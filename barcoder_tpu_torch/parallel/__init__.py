"""barcoder_tpu_torch.parallel"""
