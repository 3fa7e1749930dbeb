"""Entry points of the port: `train`, `serve` and `dryrun`, with the meshes
(`mesh`) and the fake-tensor cell inputs (`specs`) the dry run reads
(counterparts of `repro.launch`)."""
