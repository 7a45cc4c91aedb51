"""Dense decoder model code of the port: layers, attention, assembly and
int4 quantization."""
