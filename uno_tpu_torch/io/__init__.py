from uno_tpu_torch.io.nl import convert_nl_to_binary, read_nl

__all__ = ["read_nl", "convert_nl_to_binary"]
