'''
The import guard: the benchmark measures the port alone, so a run that has
loaded JAX, its libraries or the JAX package prints no result. Names are
compared whole, by the part before the first dot: occlusions4d_torch is the
port, occlusions4d_tpu the JAX package.
'''

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'occlusions4d_tpu')


def forbidden_modules(modules=None):
    '''Sorted top-level names of loaded modules that the benchmark forbids.'''
    modules = sys.modules if modules is None else modules
    return sorted({name.split('.', 1)[0] for name in list(modules)}
                  & set(FORBIDDEN))
