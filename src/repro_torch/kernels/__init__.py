"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, ``sm_90a``), each
with a plain PyTorch version beside it and a launch counter on its
wrapper: :mod:`.buzen` (the batched Buzen DP), :mod:`.events` (the event
engine, one event or a megastep per launch: the table transition alone,
or on the main path with each event's statistics) and
:mod:`.fused_update` (the trainer's server-side update fused with the
gradient norm), :mod:`.flash_attention` (the LM's full-sequence GQA
attention) and :mod:`.decode_attention` (the LM's one-token attention
against its KV cache).  Nothing is built at import: :mod:`.build` compiles a
kernel's library at its first launch."""
