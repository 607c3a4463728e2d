"""Checkpoint tools of the port, each run as ``python -m
genvc_tpu_torch.tools.<name>``: ``convert_checkpoint`` (a reference ``.pth``
bundle to an ``.npz`` bundle), ``export_checkpoint`` (back to ``.pth``) and
``make_inference_bundle`` (stage artifacts to one ``.npz`` bundle)."""
