"""Multi-process training and rendering on `torch.distributed`: camera-batch
data parallelism (`dp`), the multi-process launch (`hosts`), tile-row
sharding of one view (`tiles`) and primitive + tile-row sharding
(`primitives`). Port of `scgaussian_tpu/parallel/`; a process group stands
where the JAX package takes a `Mesh`, with one rank per device."""
