"""barcoder_tpu_torch.utils"""
