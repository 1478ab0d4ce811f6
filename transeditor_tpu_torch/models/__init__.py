from transeditor_tpu_torch.models.generator import Generator, GeneratorOutput
