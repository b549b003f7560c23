'''Operations and bytes of the n57344 configuration: the field's arithmetic
(work/_field.py) at its sizes.'''

from portbench.work._field import (scene_attention_forward, scene_flops,  # noqa: F401
                                   train_attention_backward, train_step_flops)
