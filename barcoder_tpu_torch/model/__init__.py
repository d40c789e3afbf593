"""barcoder_tpu.model"""
