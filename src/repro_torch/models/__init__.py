"""Decoder model code of the port (dense and MoE): layers, attention, the
MoE FFN, assembly and int4 quantization."""
