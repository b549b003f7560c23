'''
The plain reference of the benchmark: the port's networks, sampler, losses
and optimizer written in plain PyTorch (f32, no kernels), against which the
benchmark judges what the timed path produced. It imports nothing of the
port and nothing of JAX.
'''
