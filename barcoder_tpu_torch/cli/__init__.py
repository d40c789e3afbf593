"""barcoder_tpu_torch.cli"""
