'''The general drivers that run a traffic mix: each reads the parameters of
mixes/<name>.json whose "driver" names it.'''
