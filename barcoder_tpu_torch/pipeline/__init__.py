"""barcoder_tpu_torch.pipeline"""
