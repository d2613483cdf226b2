"""Distribution layer: a (data, seq) device mesh over the ranks of a
``torch.distributed`` process group, batched decode of frames split into
MCU-row bands, and the halo exchange between bands for fancy chroma — the
port of ``compeg_tpu.parallel`` (the subsystem the reference has no
counterpart for: it decodes on one wgpu device).

Not imported by ``compeg_tpu_torch`` itself; import
``compeg_tpu_torch.parallel.sharding`` and ``.multihost`` directly.
"""
