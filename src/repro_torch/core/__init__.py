"""Opt-GPTQ core in torch: Opt-GQA attention references, the paged KV
cache, int4 weight packing, ALiBi and sampling."""
