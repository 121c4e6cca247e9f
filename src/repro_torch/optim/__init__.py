from repro_torch.optim.optimizers import (AdamWConfig, AdafactorConfig,
                                          OptState, init_opt_state,
                                          opt_update)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           ef_compress_grads)
