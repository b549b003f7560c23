'''Operations and bytes, a module a configuration (work/<config>.py).'''
